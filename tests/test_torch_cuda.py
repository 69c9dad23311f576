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
bit-equal records); the lists launch and kernel C identical, element
for element, to their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dem_engine_tpu_torch import (
    DEMSolver,
    Engine,
    HertzianForceModel,
    SolverConfig,
    TimeIntegrator,
    build_case,
)
from dem_engine_tpu_torch.initializer import (
    empty_ss_table,
    make_owners,
    make_params,
    make_spheres,
    make_state,
    ss_uniq_rows,
)
from dem_engine_tpu_torch.ops import binning, forces, segred, sweep
from dem_engine_tpu_torch.ops.fused_force import (
    fused_step_ss,
    fused_step_ss_plain,
    hertz_rows_cuda,
    hertz_rows_ub_cuda,
)
from dem_engine_tpu_torch.solver import run_steps, ss_search_inputs

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture
def bed():
    _need_card()
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
                            state.tris, state.anals, params, state.time,
                            cfg.voxel_size, cfg.force_model)
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
                            state.tris, state.anals, params, state.time,
                            cfg.voxel_size, cfg.force_model)
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
    _need_card()
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


def _material_params(domain, gravity, crr, update_freq):
    return make_params(
        h=5e-6, gravity=gravity, domain=domain,
        materials={"E": np.asarray([1e7], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={"CoR": np.asarray([[0.5]], np.float32),
                        "mu": np.asarray([[0.4]], np.float32),
                        "Crr": np.asarray([[crr]], np.float32)},
        update_freq=update_freq, device="cuda")


def _random_pile(seed=1, n_clumps=60, uniq_cap=64):
    """The random 60-clump pile of tests/test_pallas_force.py (the same
    numpy draws), refreshed on the card with unique-fetch lists."""
    R = 0.01
    rng = np.random.default_rng(seed)
    side = max(2, int(np.ceil(n_clumps ** (1 / 3))))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3)[:n_clumps]
    pos = 0.1 + g * (1.9 * R) + rng.uniform(-0.2 * R, 0.2 * R, (n_clumps, 3))
    quat = rng.normal(size=(n_clumps, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    owners = make_owners(
        pos=pos, voxel_size=1.0 / 2**16, quat=quat,
        vel=rng.uniform(-0.5, 0.5, (n_clumps, 3)),
        omg=rng.uniform(-5.0, 5.0, (n_clumps, 3)),
        mass=np.full(n_clumps, 1e-2), moi=np.full((n_clumps, 3), 1e-6),
        device="cuda")
    spheres = make_spheres(
        owner=np.repeat(np.arange(n_clumps), 2),
        relpos=np.tile(np.asarray([[0.5 * R, 0, 0], [-0.5 * R, 0, 0]]),
                       (n_clumps, 1)),
        radius=np.full(2 * n_clumps, R) * rng.uniform(0.9, 1.1,
                                                       2 * n_clumps),
        device="cuda")
    cfg = SolverConfig(voxel_size=1.0 / 2**16,
                       integrator=TimeIntegrator.CENTERED_DIFFERENCE,
                       force_model=HertzianForceModel(), cap_ss=2048,
                       cap_st=8, cap_sa=8, uniq_cap=uniq_cap)
    params = _material_params([1.0] * 3, [0.0, 0.0, -9.81], 0.02, 5)
    eng = Engine(cfg)
    return eng.cfg, eng.refresh(make_state(owners, spheres, cfg), params), \
        params


def _cube_clumps(seed=0, side=12, uniq_cap=2048):
    """side^3 clumps of 27 spheres (a 3x3x3 cube at a 1.8 R spacing) on a
    grid of pitch 5 R, owner ids shuffled over the grid: facing spheres
    of face neighbours overlap by 0.6 R and those of edge neighbours by
    0.02 R, so an owner block of 128 holds ~5,800 rows (past the lists
    kernel's 2,048-row sort) and ~1,100 distinct other owners (past the
    384 records kernel B-ub stages per block). Refreshed on the card."""
    R = 0.005
    rng = np.random.default_rng(seed)
    n = side**3
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    pos = 10 * R + g[rng.permutation(n)] * (5.0 * R)
    dims = np.full(3, side * 5.0 * R + 20 * R)
    voxel_size = float(dims.max()) / 2**20
    c = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3) * (1.8 * R)
    owners = make_owners(pos=pos, voxel_size=voxel_size,
                         vel=rng.uniform(-0.1, 0.1, (n, 3)),
                         mass=np.full(n, 1e-2), moi=np.full((n, 3), 1e-6),
                         device="cuda")
    spheres = make_spheres(owner=np.repeat(np.arange(n), 27),
                           relpos=np.tile(c, (n, 1)),
                           radius=np.full(27 * n, R), device="cuda")
    cfg = SolverConfig(voxel_size=voxel_size,
                       integrator=TimeIntegrator.CENTERED_DIFFERENCE,
                       force_model=HertzianForceModel(), cap_ss=60 * n,
                       cap_st=8, cap_sa=8, uniq_cap=uniq_cap)
    params = _material_params(dims, [0.0, 0.0, 0.0], 0.0, 5)
    eng = Engine(cfg)
    return eng.cfg, eng.refresh(make_state(owners, spheres, cfg), params), \
        params


def _lists_match_plain(table, n, ub):
    """The lists launch on `table` against uniq_layout_plain, element
    for element. Returns the launch's (uidx, uniq_a, uniq_max, blk_start).
    """
    before = forces.uniq_layout_cuda.launches
    got = forces.uniq_layout_cuda(table, n, ub)
    assert forces.uniq_layout_cuda.launches == before + 1
    want = forces.uniq_layout_plain(table, n, ub)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("case", ["bed", "bed_overflow", "pile", "cubes"])
def test_lists_kernel_matches_plain(case):
    """The lists launch equals the plain _uniq_layout (both layouts) and
    the searchsorted block starts: on the bed, on the bed with 16 slots a
    block (more distinct others than slots: clamped ranks, uniq_max past
    the width), on the random pile, and on blocks longer than the
    kernel's shared-memory tile."""
    _need_card()
    if case.startswith("bed"):
        cfg, state, params = build_case(2048, update_freq=10, device="cuda")
        state = Engine(cfg).refresh(state, params)
        ub = 16 if case == "bed_overflow" else 512
    else:
        cfg, state, _ = _random_pile() if case == "pile" else _cube_clumps()
        ub = cfg.uniq_cap
    n = state.owners.n
    _, _, umax, starts = _lists_match_plain(state.ss, n, ub)
    if case == "bed_overflow":
        assert int(umax) > ub
    if case == "cubes":
        assert int(starts.diff().max()) > 2048


def test_lists_kernel_two_streams():
    """Two lists launches on two streams at once, on the bed's table and
    on the big blocks' (many more CTAs), each equal to its plain version:
    a launch shares no state with another."""
    _need_card()
    cfg, state, params = build_case(2048, update_freq=10, device="cuda")
    state = Engine(cfg).refresh(state, params)
    jobs = [(state.ss, state.owners.n, 16)]
    cfg_c, state_c, _ = _cube_clumps()
    jobs.append((state_c.ss, state_c.owners.n, cfg_c.uniq_cap))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in jobs]
    got = []
    for _ in range(3):
        for st, (t, n, ub) in zip(streams, jobs):
            with torch.cuda.stream(st):
                got.append(forces.uniq_layout_cuda(t, n, ub))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        t, n, ub = jobs[i % 2]
        for g, w in zip(out, forces.uniq_layout_plain(t, n, ub)):
            assert torch.equal(g, w)


def test_ub_kernel_big_blocks():
    """Kernel B-ub equals kernel B on owner blocks of ~5,800 rows with
    ~1,100 distinct B owners each (records past the 384 staged ones come
    through L2), and its plain version within tolerance."""
    _need_card()
    cfg, state, params = _cube_clumps()
    ss = state.ss
    assert 512 < int(ss.uniq_max) <= cfg.uniq_cap
    assert int(ss.blk_start.diff().max()) > 2048
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    args = (ss, krec, float(params.h), cfg.voxel_size, cfg.force_model)
    for u, d in zip(hertz_rows_ub_cuda(*args), hertz_rows_cuda(*args)):
        assert torch.equal(u, d)
    f_u, t_u, _ = fused_step_ss(ss, state.owners, float(params.h),
                                cfg.voxel_size, cfg.force_model, krec)
    f_p, t_p, _ = fused_step_ss_plain(ss, state.owners, float(params.h),
                                      cfg.voxel_size, cfg.force_model, krec)
    assert float(f_p.abs().max()) > 0
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


@pytest.mark.parametrize("uniq", [None, 512, 2])
def test_solver_matches_cpu(uniq):
    """The public DEMSolver on the card against the CPU: 64 clumps on a
    floor, 10 steps, rolling resistance off; with the card's default
    (unique fetch off), with unique fetch at 512 (kernel B-ub and the
    lists launch), and at 2, which OVF_UNIQ makes the engine grow. The
    CPU runs without unique fetch in every case."""
    _need_card()
    out = {}
    before = (forces.uniq_layout_cuda.launches,
              hertz_rows_ub_cuda.launches)
    for dev in ("cuda", "cpu"):
        s = DEMSolver(device=dev)
        s.SetVerbosity("QUIET")
        if uniq is not None:
            s.SetFusedUniqueFetch(uniq)
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
        if dev == "cuda":
            width = s.engine.cfg.uniq_cap
            ran = (forces.uniq_layout_cuda.launches - before[0],
                   hertz_rows_ub_cuda.launches - before[1])
    if uniq is None:
        assert width == 0 and ran == (0, 0)
    else:
        assert width >= uniq and min(ran) > 0
        if uniq == 2:
            assert width > 2  # grown past the lists' overflow
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


def _sweep_both(pos, reach, family, mask, cap, box=1.0, member=None):
    """find_pairs_ss on the card and on the CPU from the same arrays:
    the pair tables and counts must be identical."""
    out = {}
    for dev in ("cuda", "cpu"):
        t = [torch.as_tensor(x, device=dev) for x in
             (pos, reach, np.arange(len(reach), dtype=np.int32), family)]
        bs, nb = binning.build_grid(torch.full((3,), box, device=dev),
                                    t[1].max() if len(reach) else
                                    torch.tensor(0.01, device=dev))
        out[dev] = sweep.find_pairs_ss(
            *t, torch.as_tensor(mask, device=dev), bs, nb, cap,
            member=None if member is None else torch.as_tensor(
                member, device=dev))
    (ka, kb, kn, _), (pa, pb, pn, _) = out["cuda"], out["cpu"]
    assert int(kn) == int(pn)
    assert torch.equal(ka.cpu(), pa) and torch.equal(kb.cpu(), pb)
    return int(pn)


@pytest.mark.parametrize("case", ["overfull_bin", "sparse", "past_cap",
                                  "no_sphere", "one_sphere", "member",
                                  "member_past_cap", "member_none"])
def test_sweep_kernel_edge_tables(case):
    """Kernel C against the plain sweep on tables the bed does not make:
    1,200 spheres in one bin (a window longer than the 512 staged
    slots), sparse random spheres whose 256-sphere tiles span many bin
    rows (with a family mask), the same with a count past `cap`, tables
    of no sphere and of one, and member tables (a fifth of the spheres
    left out, so sentinel rows fill the tail of the first S rows, with
    and without a count past `cap`; no member at all)."""
    _need_card()
    rng = np.random.default_rng(3)
    f32 = np.float32
    mask = np.ones((256, 256), bool)
    if case == "overfull_bin":
        # bin size 2 * 0.01 * 1.01: bin 25 of each axis is [0.505, 0.5252)
        pos = rng.uniform(0.506, 0.524, (1200, 3)).astype(f32)
        n = _sweep_both(pos, np.full(1200, 0.01, f32),
                        np.zeros(1200, np.int32), mask, 1_000_000)
        assert n > 100_000
        return
    if case in ("no_sphere", "one_sphere"):
        k = 0 if case == "no_sphere" else 1
        assert _sweep_both(rng.uniform(0.1, 0.9, (k, 3)).astype(f32),
                           np.full(k, 0.01, f32), np.zeros(k, np.int32),
                           mask, 64) == 0
        return
    pos = rng.uniform(0.02, 0.98, (20_000, 3)).astype(f32)
    reach = (0.012 * rng.uniform(0.8, 1.2, 20_000)).astype(f32)
    family = rng.integers(0, 3, 20_000).astype(np.int32)
    mask[1, 2] = mask[2, 1] = False
    cap = 100 if case.endswith("past_cap") else 200_000
    member = None
    if case.startswith("member"):
        member = rng.uniform(size=20_000) < (0.0 if case == "member_none"
                                             else 0.8)
    n = _sweep_both(pos, reach, family, mask, cap, member=member)
    assert n == 0 if case == "member_none" else n > 1000


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


def test_poly_engine_matches_cpu():
    """The poly bed with its plate (two-class CD: kernel C on two member
    tables; the ST table through kernel A): one refresh and 10 steps on
    the card against the CPU, pair sets of SS, ST and SA equal, owner
    vel/omg within 2e-4 (rolling resistance off)."""
    _need_card()
    legs = {}
    for dev in ("cuda", "cpu"):
        cfg, st, pr = build_case(2048, update_freq=10, poly_frac=0.2,
                                 with_mesh=True, plate_grid=4,
                                 plate_z=0.01, device=dev)
        pr = pr.replace(pair_props={**pr.pair_props,
                                    "Crr": torch.zeros((1, 1), device=dev)})
        eng = Engine(cfg)
        st = eng.refresh(st, pr)
        sets = [{tuple(x) for x in torch.stack([t.idA, t.idB], 1).cpu()
                 .numpy().tolist() if x[0] >= 0} for t in (st.ss, st.st,
                                                            st.sa)]
        legs[dev] = (run_steps(st, pr, eng.cfg, 10), sets)
    (g, gs), (c, cs) = legs["cuda"], legs["cpu"]
    assert gs == cs and len(cs[1]) > 0
    assert _rel(c.owners.vel, g.owners.vel.cpu()) <= 2e-4
    assert _rel(c.owners.omg, g.owners.omg.cpu()) <= 2e-4


def test_families_solver_matches_cpu():
    """Family prescriptions and a rule through the public DEMSolver on
    the card against the CPU: 64 spheres on a floor, the bottom layer
    fixed with its (1, 1) contacts off, the top layer driven down by a
    velocity of time, a rule moving the middle layers' spheres past
    x = 0 into a family with an added acceleration; 10 steps, families
    equal, velocities within 2e-4 (rolling resistance off). On the card
    10 more steps run under torch.cuda.set_sync_debug_mode("error"), the
    refresh before them: a step reads nothing back."""
    _need_card()
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
        b = s.AddClumps(t, g * 0.0099 - 0.02)
        b.SetFamilies(np.where(g[:, 2] == 0, 1, np.where(g[:, 2] == 3, 2,
                                                         0)))
        s.AddBCPlane([0, 0, -0.026], [0, 0, 1], mat)
        s.SetFamilyFixed(1)
        s.DisableContactBetweenFamilies(1, 1)
        s.SetFamilyPrescribedLinVel(2, 0, 0,
                                    lambda t: -0.05 * torch.cos(2e3 * t))
        s.ChangeFamilyWhen(0, 3, lambda v, t: v.pos[:, 0] > 0.05)
        s.AddFamilyPrescribedAcc(3, 0, 0, -9.81)
        s.SetInitTimeStep(1e-5)
        s.SetGravitationalAcceleration([0, 0, -9.81])
        s.SetCDUpdateFreq(10)
        s.Initialize()
        s.DoDynamics(1e-4)
        out[dev] = (s.GetOwnerVelocity(), s.GetOwnerFamily())
        if dev == "cuda":
            pk = s.params.replace(max_drift=torch.tensor(
                10, dtype=torch.int32, device=dev))
            st, h = s.engine.refresh(s.state, pk), float(s.params.h)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st = run_steps(st, pk, s.engine.cfg, 10, h=h)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.isfinite(st.owners.vel).all()
    (vg, fg), (vc, fc) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(fg, fc)
    assert (fc == 3).any() and not vc[fc == 1].any()
    assert np.abs(vg - vc).max() <= 2e-4 * np.abs(vc).max()


def test_read_side_matches_cpu(tmp_path):
    """The read side of DEMSolver on the card against the CPU: 64 clumps
    on a floor after 10 steps (Crr = 0). Every inspector quantity with no
    region and a box, the contact file's rows (one B-extras launch) and
    values, the clump file's types; ProfileStageTimings leaves the card's
    state bit for bit; the K-step windows of DoDynamics raise nothing
    under sync-debug "error" with the timers on."""
    _need_card()
    from dem_engine_tpu_torch import BoxRegion
    from dem_engine_tpu_torch.ops import fused_force

    quantities = [f"clump_{m}_{a}" for m in ("max", "min") for a in "xyz"] + [
        "clump_max_absv", "clump_absv", "clump_kinetic_energy", "clump_mass",
        "clump_volume", "clump_count"]
    out = {}
    for dev in ("cuda", "cpu"):
        s = DEMSolver(device=dev)
        s.SetVerbosity("QUIET")
        s.InstructBoxDomainDimension(0.1, 0.1, 0.1)
        mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                              "Crr": 0.0})
        t = s.LoadSphereType(1e-3, 0.005, mat)
        t.AssignName("ball")
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        s.AddClumps(t, g * 0.0099 - 0.02)
        s.AddBCPlane([0, 0, -0.026], [0, 0, 1], mat)
        s.SetInitTimeStep(1e-5)
        s.SetGravitationalAcceleration([0, 0, -9.81])
        s.SetCDUpdateFreq(5)
        s.Initialize()
        s.DoDynamics(1e-4)
        box = BoxRegion([-0.05, -0.05, -0.05], [0.0, 0.0, 0.0])
        vals = {(q, r is None): s.CreateInspector(q, r).GetValue()
                for q in quantities for r in (None, box)}
        before = fused_force.hertz_extras_cuda.launches
        s.WriteContactFile(str(tmp_path / f"{dev}.csv"))
        extras = fused_force.hertz_extras_cuda.launches - before
        s.WriteClumpFile(str(tmp_path / f"{dev}_clumps.csv"))
        out[dev] = (s, vals, extras)
    s, vals, extras = out["cuda"]
    _, ref, extras_cpu = out["cpu"]
    assert extras == 1 and extras_cpu == 0
    vmax = np.abs(out["cpu"][0].GetOwnerVelocity()).max()
    for key, r in ref.items():
        g = vals[key]
        if key[0] in ("clump_max_absv", "clump_absv"):
            assert abs(g - r) <= 2e-4 * vmax, key
        elif key[0] == "clump_count":
            assert g == r > 0, key
        elif key[0].startswith(("clump_max", "clump_min")):
            assert abs(g - r) <= 1e-3 * s._voxel_size + 2e-7, key
        else:
            assert g == pytest.approx(r, rel=4e-4), key
    gp, rp = (DEMSolver.ReadContactPairsFromCsv(str(tmp_path / f"{d}.csv"))
              for d in ("cuda", "cpu"))
    assert (sorted(zip(*(x.tolist() for x in gp)))
            == sorted(zip(*(x.tolist() for x in rp))))
    assert list(DEMSolver.ReadClumpXyzFromCsv(
        str(tmp_path / "cuda_clumps.csv"))) == ["ball"]
    kept = {f.name: getattr(s.state.owners, f.name).clone()
            for f in dataclasses.fields(s.state.owners)
            if isinstance(getattr(s.state.owners, f.name), torch.Tensor)}
    stages = s.ProfileStageTimings(reps=2)
    assert all(np.isfinite(v) and v >= 0 for v in stages.values())
    for name, t in kept.items():
        assert torch.equal(t, getattr(s.state.owners, name)), name
    timed_steps = s.engine.timed_steps

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return timed_steps(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    s.engine.timed_steps = guarded
    s.ClearTimingStats()
    s.DoDynamics(1e-4)
    t = s.engine.read_timers()
    assert (t["refresh_n"], t["steps_n"]) == (2, 10) and t["steps_s"] > 0


def test_cohesive_solver_matches_cpu():
    """A custom force model through the public DEMSolver on the card
    against the CPU: the cohesive scene of tests/test_torch_custom.py
    (256 3-sphere clumps on a floor, cases.cohesion_model with the owner
    wildcard coh_scale, 0 on the last 32 clumps, and the geometry
    wildcard stick; Crr = 0), K = 5, 20 steps: contact_pass on the SS
    table and kernel A on its records. Owner velocities within 2e-4 of the
    largest, the same SS pairs, the friction history within 2e-4; 10 more
    steps on the card under torch.cuda.set_sync_debug_mode("error")."""
    from dem_engine_tpu_torch.cases import cohesion_model

    _need_card()
    r = 0.005
    out = {}
    for dev in ("cuda", "cpu"):
        s = DEMSolver(device=dev)
        s.SetVerbosity("QUIET")
        nx, ny, nz = 8, 8, 4
        dims = np.asarray([nx * 1.99 * r + 20 * r, ny * 1.99 * r + 20 * r,
                           nz * 3.99 * r + 40 * r])
        s.InstructBoxDomainDimension(*dims)
        mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                              "Crr": 0.0, "Cohesion": 20.0})
        s.DefineContactForceModel(cohesion_model())
        m_s = 2600 * 4 / 3 * np.pi * r**3
        i_s = 0.4 * m_s * r * r
        tmpl = s.LoadClumpType(
            3 * m_s, [3 * i_s + 2 * m_s * r * r] * 2 + [3 * i_s],
            [r, r, r], [[0, 0, -r], [0, 0, 0], [0, 0, r]], mat)
        n = nx * ny * nz
        idx = np.arange(n)
        lbf = -dims / 2
        pos = np.stack([idx % nx * 1.99 * r + 10 * r,
                        (idx // nx) % ny * 1.99 * r + 10 * r,
                        idx // (nx * ny) * 3.99 * r + 4 * r], -1) + lbf
        pos += np.random.default_rng(0).uniform(-0.1 * r, 0.1 * r,
                                                pos.shape)
        b = s.AddClumps(tmpl, pos)
        b.SetFamilies(np.where(idx >= n - 32, 1, 0))
        b.AddOwnerWildcard("coh_scale", 1.0)
        b.AddGeometryWildcard("stick", np.ones(n))
        s.AddBCPlane([0, 0, lbf[2] + 2 * r], [0, 0, 1], mat)
        s.SetInitTimeStep(1e-5)
        s.SetGravitationalAcceleration([0, 0, -9.81])
        s.SetCDUpdateFreq(5)
        s.Initialize()
        s.SetFamilyOwnerWildcardValue(1, "coh_scale", 0.0)
        s.DoDynamics(2e-4)
        ss = s.state.ss
        k = int(ss.count)
        rows = {(int(a), int(c)): i for i, (a, c) in enumerate(zip(
            ss.idA[:k].tolist(), ss.idB[:k].tolist()))}
        hist = torch.stack([ss.wildcards[w][:k] for w in sorted(
            ss.wildcards)], 1).cpu().numpy()
        out[dev] = (s.GetOwnerVelocity(), rows, hist)
        if dev == "cuda":
            pk = s.params.replace(max_drift=torch.tensor(
                5, dtype=torch.int32, device=dev))
            st, h = s.engine.refresh(s.state, pk), float(s.params.h)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st = run_steps(st, pk, s.engine.cfg, 10, h=h)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.isfinite(st.owners.vel).all()
    (vg, rg, hg), (vc, rc, hc) = out["cuda"], out["cpu"]
    assert np.abs(vg - vc).max() <= 2e-4 * np.abs(vc).max()
    assert set(rg) == set(rc) and rc
    order = [rg[key] for key in rc]
    assert np.abs(hg[order] - hc).max() <= 2e-4 * np.abs(hc).max()


def test_rest_phase_small():
    """chip_smoke.py's phase 14 (rest) at 4,096 clumps: the tuners over
    3,200 steps (each moves and stays on its ladder, no contact lost,
    kernel C identical to the plain sweep at the largest bin factor
    visited and at 1.0), the checkpoint (bit for bit after a load, the
    resumed run within 1e-3 R, a fresh solver's load bit for bit),
    UpdateClumps (exact counts, the SS table grown and logged, C
    identical on the grown table), PurgeFamily (the JAX rule's owners,
    positions bit for bit) and ChangeClumpSizes (exact scaling). The phase
    fails (SystemExit) on any miss."""
    import os
    import sys

    _need_card()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    s, tabs = chip_smoke.phase_rest(torch, 4096, 25)
    assert len(tabs) == 2 and s.GetNumClumps() == 4096 + 1
