"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100.

    python3 chip_smoke.py                      # the full check
    python3 chip_smoke.py --phases api,breakdown --clumps 16384 --steps 50

Phases, each printing its own numbers; any failure exits nonzero:
  0 env        card name and power limit, torch/CUDA/nvcc versions, the
               compute capability (must be 9.0)
  1 build      the CUDA kernels from csrc/, one nvcc per source, in parallel
  2 kernels    each kernel against its plain PyTorch version on the card,
               at the shapes of the 262,144-clump bed after one refresh
               and a few steps, with the median time of each, the bound
               the card's memory rate sets, and the time of one PyTorch
               call computing the same sums where there is one; the
               segment sums in every form (A: pair, pair onto an output,
               one side; D)
  3 parity     the 4,096-clump bed: one refresh + 10 steps on the card
               (kernels) against the same on the CPU (plain versions),
               with rolling resistance off and with its default
  4 main       Engine.advance on the 262,144-clump bed, K = 25: 100
               warm-up steps, then 250 timed steps; launch counts, memory,
               physics checks
  5 api        DEMSolver on the same bed through its public calls
               (LoadClumpType, AddClumps, AddBCPlane, Initialize,
               DoDynamics), K = 25, 250 timed steps after one warm-up
               chunk, twice: unique fetch at its default and off; launch
               counts, memory, shrunk capacities, physics checks; then one
               timed GetContactDetailedInfo
  6 device     torch.profiler, only after every timed run: the device time
               and launches per call of the segment sums (A: a step's two
               pair calls, D) against their bounds
  7 breakdown  for the main path and each API path, on a bed settled anew,
               one chunk: refresh and steps timed apart, then the device
               time and launches of a step by operation
With every phase run, the line before the last holds the kernels' JSON
record and the one before it the card's name and power limit; the last
line is the JSON verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

R_SPHERE = 0.005  # the bed's sphere radius (cases.build_case)
DEVICE = "cuda"


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def cuda_ms(torch, fn, reps=10, warm=2):
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_rows(torch, fn, per=1):
    """What ran on the device during fn() (torch.profiler): a list of
    (ms, launches, name) per kernel or memset, each divided by `per`,
    largest first; empty where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # nothing earlier runs into the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []  # kernels only: an aten op's row repeats its kernels' time
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / per / 1e3, e.count / per, e.key))
    return sorted(rows, reverse=True)


def phase_device_times(torch, n_clumps, kern, reps=10):
    """Device time and launches per call of the segment sums (kernels A
    and D) on the kernels phase's bed, built anew, from torch.profiler
    over `reps` calls; the bound is held against this time, not against
    the event median, which for a few small launches is mostly host time
    between them. A step's sums must be one zeroing and two launches, D
    one launch."""
    from dem_engine_tpu_torch.ops import segred

    eng, state, params = kernel_bed(torch, n_clumps)
    n = state.owners.n
    tables, sa, rec_bg = segsum_inputs(eng, state, params)
    for key, tag, fn, launches in (
            ("A", "A, a step's two pair calls", step_sums_call(tables, n), 3),
            ("D", "D", lambda: segred.seg_sum_sorted_v1(
                rec_bg, sa.own_b_sorted, n), 1)):
        totals = device_rows(torch, lambda: [fn() for _ in range(reps)])
        if not totals:
            fail(f"{tag}: the profiler recorded no device time")
        # per call: each kernel's mean duration times its launches per
        # call. The profiler now and then drops one of the first events of
        # a profile, so a count may fall short of reps x launches, by at
        # most a fifth
        rows = [(ms / cnt * round(cnt / reps), round(cnt / reps), name)
                for ms, cnt, name in totals]
        for (_, per, name), (_, seen, _) in zip(rows, totals):
            if not 0.8 * reps * per <= seen <= reps * per:
                fail(f"{tag}: {seen:g} events of {name[:40]} in {reps} "
                     f"calls, {per} a call would be {reps * per}")
        dev, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
        bnd = kern[key]["bound"][0]
        print(f"[device] {tag}: {dev:.4f} ms in {count} launches ("
              + "; ".join(f"{ms * 1e3:.1f} us x{cnt} {name[:40]}, {seen:g} "
                          f"events in {reps} calls"
                          for (ms, cnt, name), (_, seen, _)
                          in zip(rows, totals))
              + f"), {dev / bnd:.2f}x the bound {bnd:.4f} ms", flush=True)
        if count != launches:
            fail(f"{tag}: {count} launches, its design states {launches}")
        kern[key]["device_ms"], kern[key]["device_launches"] = dev, count


def host_us(torch, fn, reps=200):
    """Host microseconds to enqueue one fn() call (no wait for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of bytes over its memory rate and operations over its f32
    rate (published peaks of the H100 SXM at 700 W)."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def counters():
    """The launch count of every kernel wrapper, by kernel key."""
    from dem_engine_tpu_torch.ops import fused_force, segred, sweep

    return {"A": segred.seg_sum_pair, "B": fused_force.hertz_rows_cuda,
            "B-extras": fused_force.hertz_extras_cuda,
            "B-ub": fused_force.hertz_rows_ub_cuda,
            "C": sweep.sweep_table_cuda, "D": segred.seg_sum_sorted_v1}


def reset_counts():
    for w in counters().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in counters().items()}


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    from dem_engine_tpu_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    nvcc_v = (nvcc.stdout.strip().splitlines() or ["?"])[-1]
    cap = torch.cuda.get_device_capability(0)
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc: {nvcc_v} capability {cap[0]}.{cap[1]} "
          f"devices {torch.cuda.device_count()}", flush=True)
    if tuple(cap) != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for 9.0")
    return card


def phase_build():
    from dem_engine_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log().splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    for ln in regs:
        print(f"[build] ptxas: {ln}")
    print(f"[build] {path.name} in {dt:.1f} s", flush=True)


def settled_case(torch, n_clumps, steps, update_freq=25):
    from dem_engine_tpu_torch import Engine, build_case

    cfg, state, params = build_case(n_clumps, update_freq=update_freq,
                                    device=DEVICE)
    eng = Engine(cfg)
    state = eng.advance(state, params, steps, update_freq)
    return eng, state, params


def kernel_bed(torch, n_clumps):
    """The bed whose tables the kernels are held on: three steps, then
    the next refresh's tables. Returns (engine, state, params)."""
    eng, state, params = settled_case(torch, n_clumps, steps=3)
    state = eng.refresh(state, params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device=DEVICE)))
    return eng, state, params


def segsum_inputs(eng, state, params):
    """One step's wrench rows on `state`: the SS table's from kernel B,
    the SA table's from contact_pass. Returns ([SS, SA] argument tuples of
    seg_sum_pair, the SA table, its B rows in grouped order)."""
    from dem_engine_tpu_torch.ops import forces
    from dem_engine_tpu_torch.ops.fused_force import hertz_rows_cuda

    cfg, ss = eng.cfg, state.ss
    rec_a, rec_b, _ = hertz_rows_cuda(
        ss, forces.pack_kinematics(state.owners, world_omg=True),
        float(params.h), cfg.voxel_size, cfg.force_model)
    p = forces.contact_pass("sa", state.sa, state.owners, state.spheres,
                            state.anals, params, state.time, cfg.voxel_size,
                            cfg.force_model,
                            krec=forces.pack_kinematics(state.owners))
    sa = p["table"]
    tables = [(rec_a, ss.own_a, rec_b, ss.own_b_sorted, ss.perm_b),
              (p["rec_a"], sa.own_a, p["rec_b"], sa.own_b_sorted, sa.perm_b)]
    return tables, sa, p["rec_b"][sa.perm_b.long()].contiguous()


def step_sums_call(tables, n):
    """A step's wrench sums: the SS table's pair call makes the
    accumulator, the SA table's adds onto it."""
    from dem_engine_tpu_torch.ops import segred

    return lambda: segred.seg_sum_pair(
        *tables[1], n, out=segred.seg_sum_pair(*tables[0], n))


def bytes_A(ids, n, perm=None):
    """Bytes and operations of one side of a segment sum, its output
    apart: every id, dead ones too (which row is live is read from them),
    and the rows of live ids with their permutation entries."""
    live = int(((ids >= 0) & (ids < n)).sum())
    return (ids.shape[0] * 4 + live * 24
            + (live * 4 if perm is not None else 0)), live * 6


def bytes_B(ss, n_owners, extras=False, ub=False):
    """Bytes and operations of one fused force pass: live rows stream
    their statics, wildcards and B owner index (B-ub: uidx and own_a, and
    the unique lists once), dead rows only their live marker; each owner
    record is read once; every row's outputs are written."""
    cap = ss.cap
    live = int((ss.fstat_a[0] >= 0).sum())
    wc = 16 if ss.wildcards else 0
    b = live * (64 + wc + 4) + (cap - live) * 4 + n_owners * 64
    b += cap * (48 + wc) + (cap * 36 if extras else 0)
    if ub:
        b += live * 4 + ss.uniq_a.shape[0] * 4
    return b, live * 250


def index_add_call(torch, rec, ids, n, perm=None):
    """One index_add_ computing the same owner sums as a segment-sum call,
    its destination row per record precomputed."""
    dest = torch.where((ids >= 0) & (ids < n), ids, n).long()
    if perm is not None:
        dest = torch.empty_like(dest).scatter_(0, perm.long(), dest)

    def call():
        return torch.zeros((n + 1, 6), dtype=rec.dtype,
                           device=rec.device).index_add_(0, dest, rec)
    return call


def phase_kernels(torch, n_clumps):
    """Each kernel against its plain version on the same card inputs."""
    import dataclasses

    from dem_engine_tpu_torch import Engine
    from dem_engine_tpu_torch.initializer import empty_ss_table, ss_uniq_rows
    from dem_engine_tpu_torch.ops import binning, forces, segred, sweep
    from dem_engine_tpu_torch.ops.fused_force import (
        fused_step_ss, fused_step_ss_plain, hertz_extras_cuda, hertz_rows,
        hertz_rows_cuda, hertz_rows_ub_cuda, n_blocks_of, uniq_records)
    from dem_engine_tpu_torch.solver import ss_search_inputs

    eng, state, params = kernel_bed(torch, n_clumps)
    cfg = eng.cfg
    params_k = params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device=DEVICE))
    n = state.owners.n
    out = {}

    # --- C: pair search --------------------------------------------------
    q = ss_search_inputs(state, params_k, cfg.voxel_size)
    S = state.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     S)
    mpb = int(tab.max_occ)
    ka, kb, kn = sweep.sweep_table_cuda(tab, S, q["family_mask"],
                                        q["nb_cd"], cfg.cap_ss)
    pa, pb, pn = binning.sweep_table(tab, S, q["family_mask"], q["nb_cd"],
                                     cfg.cap_ss, mpb)
    same = (int(kn) == int(pn) and torch.equal(ka, pa)
            and torch.equal(kb, pb))
    ms = cuda_ms(torch, lambda: sweep.sweep_table_cuda(
        tab, S, q["family_mask"], q["nb_cd"], cfg.cap_ss))
    pms = cuda_ms(torch, lambda: binning.sweep_table(
        tab, S, q["family_mask"], q["nb_cd"], cfg.cap_ss, mpb))
    # sorted records (28 B), bin ids, bin coordinates in; the pair table out
    bnd = bound(tab.n_rows * 44 + 256 * 256 + cfg.cap_ss * 8,
                int(kn) * 10)
    print(f"[kernels] C sweep: spheres {S} pairs {int(kn)} (plain "
          f"{int(pn)}) max bin occupancy {mpb} identical={same} "
          f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bnd[0]:.4f} ms "
          f"({bnd[1]})", flush=True)
    if not same:
        fail("kernel C pair table differs from the plain sweep")
    out["C"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound=bnd,
                    library_ms=None)

    # --- B: fused SS force pass -------------------------------------------
    h = float(params.h)
    model = cfg.force_model
    krec_w = forces.pack_kinematics(state.owners, world_omg=True)
    fk, tk, tab_k = fused_step_ss(state.ss, state.owners, h, cfg.voxel_size,
                                  model, krec_w)
    fp, tp, tab_p = fused_step_ss_plain(state.ss, state.owners, h,
                                        cfg.voxel_size, model, krec_w)
    e_f, e_t = rel_err(fp.cpu(), fk.cpu()), rel_err(tp.cpu(), tk.cpu())
    live = state.ss.idA >= 0
    e_wc = max(rel_err(tab_p.wildcards[k][live].cpu(),
                       tab_k.wildcards[k][live].cpu())
               for k in tab_p.wildcards)
    abs_b = float(max((fp - fk).abs().max(), (tp - tk).abs().max()))
    ss = state.ss
    lv = ss.fstat_a[0] >= 0
    oa = torch.where(lv, ss.own_a, 0).long()
    ob = torch.where(lv, ss.own_b, 0).long()
    names = sorted(ss.wildcards)
    wc = torch.stack([ss.wildcards[k] for k in names])
    ms = cuda_ms(torch, lambda: hertz_rows_cuda(ss, krec_w, h,
                                                cfg.voxel_size, model))
    pms = cuda_ms(torch, lambda: hertz_rows(ss.fstat_a, wc, krec_w[oa],
                                            krec_w[ob], h, cfg.voxel_size,
                                            True))
    bnd = bound(*bytes_B(ss, n))
    print(f"[kernels] B fused force: rows {ss.cap} live {int(ss.count)} "
          f"owner force err {e_f:.2e} torque err {e_t:.2e} (tol 2e-4) "
          f"wildcard err {e_wc:.2e} (tol 1e-3) kernel {ms:.3f} ms "
          f"plain {pms:.3f} ms bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    if not (e_f <= 2e-4 and e_t <= 2e-4 and e_wc <= 1e-3):
        fail("kernel B disagrees with its plain version")
    out["B"] = dict(max_abs_err=abs_b, ms=ms, plain_ms=pms, bound=bnd,
                    library_ms=None)

    # --- B-extras: the query outputs of the same launch -------------------
    _, _, xk = fused_step_ss(ss, state.owners, h, cfg.voxel_size, model,
                             krec_w, extras=True)
    _, _, xp = fused_step_ss_plain(ss, state.owners, h, cfg.voxel_size,
                                   model, krec_w, extras=True)
    errs, abs_x = {}, 0.0
    for name in ("force", "torque", "cpoint"):
        k, pl = getattr(xk, name), getattr(xp, name)
        errs[name] = rel_err(pl[live].cpu(), k[live].cpu())
        abs_x = max(abs_x, float((k - pl).abs().max()))
        if k[~live].any():
            fail(f"kernel B-extras left a dead row's {name} nonzero")
    ms = cuda_ms(torch, lambda: hertz_extras_cuda(ss, krec_w, h,
                                                  cfg.voxel_size, model))
    pms = cuda_ms(torch, lambda: hertz_rows(ss.fstat_a, wc, krec_w[oa],
                                            krec_w[ob], h, cfg.voxel_size,
                                            True, extras=True))
    bnd = bound(*bytes_B(ss, n, extras=True))
    print(f"[kernels] B-extras: force err {errs['force']:.2e} torque-only "
          f"err {errs['torque']:.2e} cpoint err {errs['cpoint']:.2e} "
          f"(tol 2e-4) kernel {ms:.3f} ms plain {pms:.3f} ms bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    if not max(errs.values()) <= 2e-4:
        fail("kernel B-extras disagrees with its plain version")
    out["B-extras"] = dict(max_abs_err=abs_x, ms=ms, plain_ms=pms,
                           bound=bnd, library_ms=None)

    # --- B-ub: the unique-fetch launch, on the same refresh with lists ----
    cfg_u = dataclasses.replace(cfg, uniq_cap=512)
    eng_u = Engine(cfg_u)
    st_u = eng_u.refresh(state.replace(ss=empty_ss_table(
        cfg_u, cfg.cap_ss, DEVICE, ss_uniq_rows(cfg_u, n))), params_k)
    su = st_u.ss
    ub = su.uniq_a.shape[0] // n_blocks_of(n)
    direct = hertz_rows_cuda(su, krec_w, h, cfg.voxel_size, model)
    via_ub = hertz_rows_ub_cuda(su, krec_w, h, cfg.voxel_size, model)
    identical = all(torch.equal(a, b) for a, b in zip(direct, via_ub))
    e_direct = max(rel_err(a.cpu(), b.cpu()) for a, b in zip(direct, via_ub))
    fu, tu, tab_u = fused_step_ss(su, st_u.owners, h, cfg.voxel_size, model,
                                  krec_w)
    fpu, tpu, tab_pu = fused_step_ss_plain(su, st_u.owners, h,
                                           cfg.voxel_size, model, krec_w)
    e_f, e_t = rel_err(fpu.cpu(), fu.cpu()), rel_err(tpu.cpu(), tu.cpu())
    live_u = su.idA >= 0
    e_wc = max(rel_err(tab_pu.wildcards[k][live_u].cpu(),
                       tab_u.wildcards[k][live_u].cpu())
               for k in tab_pu.wildcards)
    abs_u = float(max((fpu - fu).abs().max(), (tpu - tu).abs().max()))
    lvu = su.fstat_a[0] >= 0
    oau = torch.where(lvu, su.own_a, 0).long()
    wcu = torch.stack([su.wildcards[k] for k in names])
    ms = cuda_ms(torch, lambda: hertz_rows_ub_cuda(su, krec_w, h,
                                                   cfg.voxel_size, model))
    pms = cuda_ms(torch, lambda: hertz_rows(
        su.fstat_a, wcu, krec_w[oau], uniq_records(su, krec_w), h,
        cfg.voxel_size, True))
    bnd = bound(*bytes_B(su, n, ub=True))
    print(f"[kernels] B-ub unique fetch: {n_blocks_of(n)} blocks x {ub} "
          f"slots, "
          f"largest unique count {int(su.uniq_max)}; against kernel B "
          f"identical={identical} (err {e_direct:.2e}, tol 1e-6); against "
          f"its plain version owner force err {e_f:.2e} torque err "
          f"{e_t:.2e} (tol 2e-4) wildcard err {e_wc:.2e} (tol 1e-3); "
          f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bnd[0]:.4f} ms "
          f"({bnd[1]})", flush=True)
    if not (e_direct <= 1e-6 and e_f <= 2e-4 and e_t <= 2e-4
            and e_wc <= 1e-3):
        fail("kernel B-ub disagrees with kernel B or its plain version")
    out["B-ub"] = dict(max_abs_err=abs_u, ms=ms, plain_ms=pms, bound=bnd,
                       library_ms=None)
    del eng_u, st_u, su, direct, via_ub, tab_u, tab_pu

    # --- A: owner-segment sums, the two pair calls of one step ------------
    tables, sa, rec_bg = segsum_inputs(eng, state, params)
    calls = [side for ra, ia, rb, ib, pb in tables
             for side in ((ra, ia, None), (rb, ib, pb))]
    # both sides add f32 in an order set by atomics, and the floor owner
    # sums thousands of same-sign rows: the kernel is held to the exact
    # (float64) sum, 1e-5 of the largest |sum|, in each form: a pair call
    # per table, the second table added onto the first's output, and the
    # one-side call; the plain version's own error is printed beside
    def exact_of(rec, ids, perm):
        return segred.seg_sum_plain(rec.double(), ids, n, perm=perm)

    def err(got, exact):
        return float((got.double() - exact).abs().max()) / max(
            float(exact.abs().max()), 1e-30)

    exact_t = [exact_of(ra, ia, None) + exact_of(rb, ib, pb)
               for ra, ia, rb, ib, pb in tables]
    errs = {"pair": max(err(segred.seg_sum_pair(*t, n), e)
                        for t, e in zip(tables, exact_t))}
    acc = segred.seg_sum_pair(*tables[0], n)
    onto = segred.seg_sum_pair(*tables[1], n, out=acc)
    errs["pair onto out"] = err(onto, exact_t[0] + exact_t[1])
    if onto.data_ptr() != acc.data_ptr():
        fail("seg_sum_pair(out=) did not add in place")
    errs["one side"] = max(
        err(segred.seg_sum_sorted(r, i, n, perm=pm), exact_of(r, i, pm))
        for r, i, pm in calls)
    plain_err = max(err(segred.seg_sum_plain(r, i, n, perm=pm),
                        exact_of(r, i, pm)) for r, i, pm in calls)
    abs_a = float((onto - sum(segred.seg_sum_plain(r, i, n, perm=pm)
                              for r, i, pm in calls)).abs().max())
    floor_rows = int((sa.own_b_sorted < n).sum())

    step_sums = step_sums_call(tables, n)

    def all_calls(fn):
        return lambda: [fn(r, i, n, perm=pm) for r, i, pm in calls]

    lib = [index_add_call(torch, r, i, n, pm) for r, i, pm in calls]
    ms = cuda_ms(torch, step_sums)
    ms_one = cuda_ms(torch, all_calls(segred.seg_sum_sorted))
    pms = cuda_ms(torch, all_calls(segred.seg_sum_plain))
    lms = cuda_ms(torch, lambda: [c() for c in lib])
    # what step_sums moves: the four sides in, one (n, 6) accumulator out
    moved = [bytes_A(i, n, pm) for _, i, pm in calls]
    bnd = bound(sum(m[0] for m in moved) + n * 24, sum(m[1] for m in moved))
    print(f"[kernels] A segment sums (a step's SS and SA tables, both sides "
          f"of each in one launch; {floor_rows} SA rows on the floor owner) "
          f"error against the float64 sum "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol 1e-5; plain {plain_err:.2e}); two pair calls {ms:.3f} ms "
          f"by events; four one-side calls {ms_one:.3f} ms; plain {pms:.3f} "
          f"ms index_add_ {lms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})",
          flush=True)
    if not max(errs.values()) <= 1e-5:
        fail("kernel A disagrees with its plain version")
    out["A"] = dict(max_abs_err=abs_a, ms=ms, plain_ms=pms, bound=bnd,
                    library_ms=lms)

    # --- D: windowed segment sum (v1) on the SA table's shape -------------
    # the B side, grouped (the floor owner holds every live row: no
    # spill), and the A side (one owner per row: a 512-row tile spans
    # more owners than the 256-owner window, so it must spill)
    errs_d, abs_d, spills = [], 0.0, []
    for rec, ids in ((rec_bg, sa.own_b_sorted), (tables[1][0], sa.own_a)):
        k, k_spill = segred.seg_sum_sorted_v1(rec, ids, n)
        pl, p_spill = segred.seg_sum_v1_plain(rec, ids, n)
        exact, _ = segred.seg_sum_v1_plain(rec.double(), ids, n)
        scale = max(float(exact.abs().max()), 1e-30)
        errs_d.append(float((k.double() - exact).abs().max()) / scale)
        abs_d = max(abs_d, float((k - pl).abs().max()))
        spills.append((bool(k_spill), bool(p_spill)))
    ms = cuda_ms(torch, lambda: segred.seg_sum_sorted_v1(
        rec_bg, sa.own_b_sorted, n))
    pms = cuda_ms(torch, lambda: segred.seg_sum_v1_plain(
        rec_bg, sa.own_b_sorted, n))
    lib_d = index_add_call(torch, rec_bg, sa.own_b_sorted, n)
    lms = cuda_ms(torch, lib_d)

    def call_d():
        return segred.seg_sum_sorted_v1(rec_bg, sa.own_b_sorted, n)

    host_d, host_lib = host_us(torch, call_d), host_us(torch, lib_d)
    b_d, o_d = bytes_A(sa.own_b_sorted, n)
    bnd = bound(b_d + n * 24 + 1, o_d)  # the sums and the flag byte out
    print(f"[kernels] D windowed segment sum: rows {sa.cap}; floor side "
          f"spill (kernel, plain) {spills[0]} err {errs_d[0]:.2e}; clump "
          f"side spill {spills[1]} err {errs_d[1]:.2e} (tol 1e-5 against "
          f"the float64 sum of the same rule) kernel {ms:.3f} ms by events, "
          f"{host_d:.1f} us of host per call; plain {pms:.3f} ms; "
          f"index_add_ {lms:.3f} ms by events, {host_lib:.1f} us of host "
          f"per call; bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    if not (max(errs_d) <= 1e-5 and all(a == b for a, b in spills)
            and spills[0] == (False, False)):
        fail("kernel D disagrees with its plain version")
    out["D"] = dict(max_abs_err=abs_d, ms=ms, plain_ms=pms, bound=bnd,
                    library_ms=lms)
    del eng, state, tab
    torch.cuda.empty_cache()
    return out


def _pair_set(t):
    a = t.idA.cpu().numpy()
    b = t.idB.cpu().numpy()
    live = a >= 0
    return set(zip(a[live].tolist(), b[live].tolist()))


def _nudged(state, n, dev):
    """`state` with each loc component of the first `n` owners moved one
    f32 ulp up or down at random: a rounding-level perturbation."""
    import torch

    g = torch.Generator().manual_seed(0)
    toward = torch.where(torch.rand((n, 3), generator=g) < 0.5, -1e9, 1e9)
    loc = state.owners.loc.clone()
    loc[:n] = torch.nextafter(loc[:n], toward.to(dev))
    return state.replace(owners=state.owners.replace(loc=loc))


def phase_parity(torch, n_clumps):
    """The card (kernels) against the CPU (plain versions), one refresh
    and 10 steps, twice. With rolling resistance off (Crr = 0) the card is
    held to the tolerances. With the default Crr the bed is
    ill-conditioned: the rolling torque's direction is v_rot/|v_rot| for
    any |v_rot| above 1e-12, so rounding-level spin on an owner whose
    forces cancel by symmetry turns into a full Crr*|F| torque on one side
    only. There the card is held to 3x the spread between the CPU run and
    a CPU run with every clump's loc nudged by one ulp."""
    from dem_engine_tpu_torch import Engine, build_case
    from dem_engine_tpu_torch.ops.voxel import decode_host
    from dem_engine_tpu_torch.solver import run_steps

    def run(dev, crr, nudge=False):
        cfg, st, pr = build_case(n_clumps, update_freq=10, device=dev)
        if crr is not None:
            pr = pr.replace(pair_props={
                **pr.pair_props,
                "Crr": torch.full((1, 1), crr, device=dev)})
        pr = pr.replace(max_drift=torch.tensor(10, dtype=torch.int32,
                                               device=dev))
        if nudge:
            st = _nudged(st, n_clumps, dev)
        eng = Engine(cfg)
        st = eng.refresh(st, pr)
        pairs = (_pair_set(st.ss), _pair_set(st.sa))
        st = run_steps(st, pr, eng.cfg, 10)
        o = st.owners
        pos = decode_host(o.vox.cpu().numpy(), o.loc.cpu().numpy(),
                          cfg.voxel_size)
        return (o.vel.cpu().numpy(), o.omg.cpu().numpy(), pos,
                o.vox.cpu().numpy(), pairs, cfg.voxel_size)

    def gaps(ref, got):
        # positions compared decoded: an owner within rounding of a voxel
        # face may sit in the neighbouring voxel on one side; the
        # tolerance is the loc tolerance (1e-3 of the voxel size)
        return (rel_err(ref[0], got[0]), rel_err(ref[1], got[1]),
                float(np.abs(ref[2] - got[2]).max() / ref[5]))

    ok = True
    for crr in (0.0, None):
        g, c = run(DEVICE, crr), run("cpu", crr)
        e_v, e_o, e_p = gaps(c, g)
        vox_diff = int((c[3] != g[3]).any(1).sum())
        same = g[4] == c[4]
        head = (f"[parity] {n_clumps} clumps, "
                f"{'Crr=0' if crr is not None else 'default Crr'}: SS pairs "
                f"{len(g[4][0])} SA pairs {len(g[4][1])} sets equal={same} "
                f"vel err {e_v:.2e} omg err {e_o:.2e} position err "
                f"{e_p:.2e} voxel, owners in another voxel {vox_diff}")
        if crr is not None:
            print(f"{head} (tol 2e-4, 2e-4, 1e-3)", flush=True)
            ok &= same and e_v <= 2e-4 and e_o <= 2e-4 and e_p <= 1e-3
            continue
        s_v, s_o, s_p = gaps(c, run("cpu", crr, nudge=True))
        print(f"{head}; CPU against CPU nudged by one ulp: vel {s_v:.2e} "
              f"omg {s_o:.2e} position {s_p:.2e} voxel (tol 3x those)",
              flush=True)
        ok &= (same and e_v <= 3 * s_v and e_o <= 3 * s_o
               and e_p <= 3 * s_p)
    if not ok:
        fail("the card's slice disagrees with the CPU's")


def physics(torch, state, voxel_size, tag):
    """Finite state, no sphere centre within half a radius of the floor
    plane (z = 2R from the domain's lower corner), SS contacts present."""
    from dem_engine_tpu_torch.solver import sphere_world_pos

    o = state.owners
    finite = all(bool(torch.isfinite(x).all())
                 for x in (o.vel, o.omg, o.loc, o.quat))
    z = sphere_world_pos(o, state.spheres, voxel_size)[:, 2]
    min_gap = float((z - 2 * R_SPHERE).min())
    print(f"[{tag}] physics: finite={finite} lowest sphere centre "
          f"{min_gap / R_SPHERE:.3f} R above the floor (need > 0.5 R), "
          f"ss.count {int(state.ss.count)} > 0", flush=True)
    if not (finite and min_gap > 0.5 * R_SPHERE
            and int(state.ss.count) > 0):
        fail(f"{tag} physics checks")


def phase_main(torch, n_clumps, k, warm, steps):
    eng, state, params = settled_case(torch, n_clumps, warm, update_freq=k)
    torch.cuda.synchronize()
    attempts0 = eng.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = eng.advance(state, params, steps, k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    refreshes = eng.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    ms_step = dt * 1e3 / steps
    print(f"[main] {n_clumps} clumps, K={k}, {steps} steps after {warm} "
          f"warm-up: {ms_step:.3f} ms/step, "
          f"{n_clumps * steps / dt:.4g} clump-steps/s; ss.count "
          f"{int(state.ss.count)} (cap {eng.cfg.cap_ss}) sa.count "
          f"{int(state.sa.count)} (cap {eng.cfg.cap_sa}); peak memory "
          f"{mem / 2**30:.2f} GiB", flush=True)
    expect = {"A": 2 * steps, "B": steps, "B-extras": 0, "B-ub": 0,
              "C": refreshes, "D": 0}
    print(f"[main] launches {launches}, expected {expect} "
          f"({refreshes} refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the main path")
    physics(torch, state, eng.cfg.voxel_size, "main")
    return launches


def phase_breakdown(torch, eng, state, params, k, tag="breakdown"):
    """Where one chunk's time goes: the refresh and the K steps timed
    apart (synchronised host clock), then the device time of 5 steps by
    operation from torch.profiler, against their unprofiled wall time."""
    from dem_engine_tpu_torch.solver import run_steps

    params_k = params.replace(max_drift=torch.tensor(
        k, dtype=torch.int32, device=DEVICE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.refresh(state, params_k)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = run_steps(state, params_k, eng.cfg, k)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = 5
    state = run_steps(state, params_k, eng.cfg, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t2) / n * 1e3
    print(f"[{tag}] refresh {(t1 - t0) * 1e3:.3f} ms, steps "
          f"{(t2 - t1) * 1e3 / k:.3f} ms/step, chunk of K={k}: "
          f"{((t1 - t0) + (t2 - t1)) * 1e3 / k:.3f} ms/step", flush=True)
    rows = device_rows(
        torch, lambda: run_steps(state, params_k, eng.cfg, n), per=n)
    if not rows:
        print(f"[{tag}] profiler recorded no device time: device "
              "share not measured", flush=True)
        return
    dev = sum(r[0] for r in rows)
    print(f"[{tag}] per step: device busy {dev:.3f} ms of "
          f"{wall:.3f} ms wall (idle share {1 - dev / wall:.2f}), "
          f"{sum(r[1] for r in rows):g} kernel launches", flush=True)
    for ms, cnt, name in rows[:8]:
        print(f"[{tag}]   {ms:.3f} ms/step  x{cnt:g}  {name[:70]}",
              flush=True)


API_H = 5e-6  # the API runs' step size
API_RUNS = (("unique fetch 512", None), ("unique fetch off", 0))


def api_solver(n_clumps, k, uniq):
    """DEMSolver on the bench bed through its public calls: the clump
    template and lattice of cases.build_case, the floor by AddBCPlane."""
    from dem_engine_tpu_torch import DEMSolver
    from dem_engine_tpu_torch.cases import R, bed_geometry

    geo = bed_geometry(n_clumps)
    dims = geo["dims"]
    s = DEMSolver(device=DEVICE)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e9, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.01})
    tmpl = s.LoadClumpType(geo["mass"], geo["moi"], [R] * 3, geo["rel"], mat)
    s.AddClumps(tmpl, geo["pos"] - dims / 2)
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(5e-6)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    if uniq is not None:
        s.SetFusedUniqueFetch(uniq)
    s.Initialize()
    return s


def phase_api(torch, n_clumps, k, steps):
    """DoDynamics through DEMSolver, with unique fetch at its default and
    off; then one contact query. Returns the launch counts of the default
    run's steps and of the query."""
    h = API_H
    counts = {}
    for label, uniq in API_RUNS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        s = api_solver(n_clumps, k, uniq)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        s.DoDynamics(k * h)  # one warm-up chunk
        attempts0 = s.engine.refresh_attempts
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        s.DoDynamics(steps * h)  # synchronises before it returns
        dt = time.perf_counter() - t0
        launches = read_counts()
        refreshes = s.engine.refresh_attempts - attempts0
        mem = torch.cuda.max_memory_allocated()
        cfg = s.engine.cfg
        st = s.state
        print(f"[api] {label}: {s.GetNumClumps()} clumps, K={k}, {steps} "
              f"steps after a {k}-step warm-up (Initialize {t_init:.2f} s): "
              f"{dt * 1e3 / steps:.3f} ms/step, "
              f"{n_clumps * steps / dt:.4g} clump-steps/s; peak memory "
              f"{mem / 2**30:.2f} GiB; ss.count {int(st.ss.count)} "
              f"sa.count {int(st.sa.count)}; caps after maybe_shrink "
              f"cap_ss {cfg.cap_ss} cap_sa {cfg.cap_sa}, uniq_cap "
              f"{cfg.uniq_cap} ({s.engine.shrinks} shrinks)", flush=True)
        on = uniq is None
        expect = {"A": 2 * steps, "B": 0 if on else steps, "B-extras": 0,
                  "B-ub": steps if on else 0, "C": refreshes, "D": 0}
        print(f"[api] launches {launches}, expected {expect} "
              f"({refreshes} refresh attempts)", flush=True)
        if launches != expect or refreshes < steps // k:
            fail(f"launch counts do not match the API path ({label})")
        if on and not 0 < cfg.uniq_cap <= 2048:
            fail("unique fetch is off on the API's default path")
        physics(torch, st, cfg.voxel_size, "api")
        if on:
            counts["steps"] = launches
            reset_counts()
            t0 = time.perf_counter()
            info = {b["kind"]: b for b in s.GetContactDetailedInfo()}
            dt_q = time.perf_counter() - t0
            counts["query"] = q = read_counts()
            n_ss = len(info["SS"]["idA"]) if "SS" in info else 0
            finite = all(np.isfinite(b[f]).all() for b in info.values()
                         for f in ("force", "torque_only", "point"))
            print(f"[api] GetContactDetailedInfo: {dt_q * 1e3:.1f} ms, "
                  f"kinds {sorted(info)}, SS rows {n_ss}, finite={finite}, "
                  f"launches {q}", flush=True)
            if not (q["B-extras"] == 1 and n_ss == int(st.ss.count)
                    and finite and "SA" in info):
                fail("the contact query did not run the extras pass")
        del s, st
    torch.cuda.empty_cache()
    return counts


KERNELS = {
    "A": ("segment_sum", "dem_engine_tpu_torch/csrc/segred.cu",
          "dem_engine_tpu/ops/pallas_segred.py:165"),
    "B": ("fused_hertz_force", "dem_engine_tpu_torch/csrc/fused_force.cu",
          "dem_engine_tpu/ops/pallas_force.py:629"),
    "B-extras": ("fused_hertz_force_extras",
                 "dem_engine_tpu_torch/csrc/fused_force.cu",
                 "dem_engine_tpu/ops/pallas_force.py:629"),
    "B-ub": ("fused_hertz_force_unique_fetch",
             "dem_engine_tpu_torch/csrc/fused_force.cu",
             "dem_engine_tpu/ops/pallas_force.py:629"),
    "C": ("ss_pair_search", "dem_engine_tpu_torch/csrc/sweep.cu",
          "dem_engine_tpu/ops/pallas_sweep3.py:179"),
    "D": ("segment_sum_window", "dem_engine_tpu_torch/csrc/segred_v1.cu",
          "dem_engine_tpu/ops/pallas_segred.py:206"),
}
PHASES = ("kernels", "parity", "main", "breakdown", "api")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clumps", type=int, default=262144)
    ap.add_argument("--parity-clumps", type=int, default=4096)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_env(torch)
    phase_build()
    kern = (phase_kernels(torch, args.clumps) if "kernels" in phases
            else None)
    if "parity" in phases:
        phase_parity(torch, args.parity_clumps)
    main_counts = api_counts = None
    if "main" in phases:
        main_counts = phase_main(torch, args.clumps, args.k, args.warm,
                                 args.steps)
    if "api" in phases:
        api_counts = phase_api(torch, args.clumps, args.k, args.steps)
    # torch.profiler only from here on, so that no timed run follows a
    # profile in its process; the breakdowns settle their beds anew, so
    # no timed run shares the card's memory with them either
    if kern:
        phase_device_times(torch, args.clumps, kern)
    if "breakdown" in phases and "main" in phases:
        phase_breakdown(torch, *settled_case(torch, args.clumps, args.warm,
                                             update_freq=args.k), args.k)
    if "breakdown" in phases and "api" in phases:
        for label, uniq in API_RUNS:
            torch.cuda.empty_cache()
            s = api_solver(args.clumps, args.k, uniq)
            s.DoDynamics(args.k * API_H)
            phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                            tag=f"api breakdown, {label}")
            del s
    print(card)
    if kern and main_counts and api_counts:
        # each kernel's launches on the path that runs it: A, B and C on
        # the main path, B-ub on the API's default steps, B-extras in the
        # contact query; D has no caller
        launches = dict(main_counts, **{
            "B-ub": api_counts["steps"]["B-ub"],
            "B-extras": api_counts["query"]["B-extras"]})
        record = {"kernels": [
            {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": kern[key]["max_abs_err"], "ms": kern[key]["ms"],
             "plain_ms": kern[key]["plain_ms"],
             "bound_ms": kern[key]["bound"][0],
             "bound_by": kern[key]["bound"][1],
             "library_ms": kern[key]["library_ms"],
             "device_ms": kern[key].get("device_ms"),
             "device_launches": kern[key].get("device_launches")}
            for key, (name, source, replaces) in KERNELS.items()]}
        print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
