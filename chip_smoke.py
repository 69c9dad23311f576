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
               one side; D); C also with a count past its capacity; the
               lists launch (unique-fetch lists of both layouts and the
               block row starts) identical to its plain version; B-ub
               and B also on the API's own (shrunk) table; then, on the
               poly bed (below), C on both member tables of its two-class
               CD (also past cap) and A on its ST table; C also under a
               family mask (the bed's bottom layer in family 1, (1, 1)
               disabled): identical to the plain sweep, no (1, 1) pair,
               fewer pairs than with the all-true mask
  3 parity     the 4,096-clump bed: one refresh + 10 steps on the card
               (kernels) against the same on the CPU (plain versions),
               with rolling resistance off and with its default; the
               4,096-clump poly bed: one refresh, pair sets (SS, ST, SA);
               the families scene (below) at 4,096 clumps, Crr = 0: one
               chunk, pair sets and per-owner state
  4 main       Engine.advance on the 262,144-clump bed, K = 25: 100
               warm-up steps, then 250 timed steps; launch counts, memory,
               physics checks
  5 poly       Engine.advance on the poly bed: 262,144 clumps, a fifth of
               them ratio-3 (two-class CD), on the floor and a fixed plate
               of 2*16^2 triangles under the bed's middle (ST every step);
               K = 25, warm-up and timed steps as main; counts against
               the capacities, launch counts, memory, physics checks
  6 api        DEMSolver on the mono bed through its public calls
               (LoadClumpType, AddClumps, AddBCPlane, Initialize,
               DoDynamics), K = 25, 250 timed steps after one warm-up
               chunk, twice: unique fetch at its default and off; launch
               counts, memory, shrunk capacities, physics checks; then one
               timed GetContactDetailedInfo. Then the poly path through
               the API: two LoadClumpTypes, the two-class CD switched on
               by Initialize's radius rule, a free plate
               (DEMMeshConnected, 2*16^2 triangles) laid on the bed's top
               layer by AddWavefrontMeshObject; DoDynamics and a query
               with its ST block
  7 families   DEMSolver on the API's mono lattice with families: the
               bottom layer fixed (SetFamilyFixed) with its (1, 1)
               contacts disabled, the 2*16^2-triangle plate laid on the top
               layer and pressed down by a prescribed velocity of time, a
               ChangeFamilyWhen rule moving the top layer's clumps under
               the plate to a family with an added acceleration; the
               rule's step against the host's count, K = 25, 250 timed
               steps (launch counts, memory), K steps under
               torch.cuda.set_sync_debug_mode("error"); the fixed layer
               bit for bit, the plate's path against the integral of its
               velocity, no (1, 1) pair in the contact query, physics
  8 output     the read side of DEMSolver on the API's mono lattice (a
               named template), after one chunk: every inspector quantity
               with no region, a BoxRegion, a SphereRegion and the box as
               a host callable, against a float64 numpy reduction of the
               copied state, with the host time of a GetValue;
               WriteClumpFile in CSV and binary, read back with the
               ReadClump*FromCsv readers and np.load, equal to the
               getters; WriteContactFile in CSV and binary (one B-extras
               launch), its rows against the tables and
               ReadContactPairsFromCsv, its time split into the force pass,
               the device-side selection with the copies, and the
               formatting, and a force_thres run against |f| > thres;
               ProfileStageTimings(reps=5) with the state held bit for
               bit; a DoDynamics of the timed steps with each K-step
               window under torch.cuda.set_sync_debug_mode("error") and
               ShowTimingStats' counts
  9 device     torch.profiler, only after every timed run: the device time
               and launches per call of the segment sums (A: a step's two
               pair calls, D), of one C search (and one under the family
               mask), of the poly refresh's two
               C searches, of B on the main path's table, and of the
               lists launch, B-ub and B on the API's table, against their
               bounds
  10 uniq      the unique-fetch decision: the device time of one
               DoDynamics chunk (refresh + K steps) with unique fetch at
               512 and off, five alternating rounds (torch.profiler)
  11 breakdown for the main path, the poly path, each API path (the
               poly one too) and the families path, on a bed settled
               anew, one chunk: refresh
               and steps timed apart, then the device time and launches
               of a step, and of one refresh, by operation; for the poly
               path also the refresh's device time split into C x2, the
               cross search, the ST search and the rest; last, for the
               output phase, the device time of B-extras in a query on
               the API's table and the launches of a step of DoDynamics'
               K-step window with the timers on
  12 custom    configuration (a), the cohesive bed: DEMSolver on the API's
               mono lattice with a custom force model (Hertz-Mindlin plus
               cohesion 50, scaled by the owner wildcard coh_scale, 0 on
               an eighth of the clumps by SetFamilyOwnerWildcardValue,
               and the geometry wildcard stick), Crr = 0: contact_pass on
               the SS table every step, one warm-up chunk, 250 timed
               steps, launch counts (A twice a step, no B), memory,
               physics, the friction history live on the SS rows; kernel
               A on the contact_pass SS records against its plain
               version; the built-in Hertz model through contact_pass
               against kernel B on the settled table, per contact and per
               owner
  13 bonded    configuration (b), the bonded block: side^3 single spheres
               (side the cube root of --clumps: 64) in two AddClumps
               batches on a floor, the bond model,
               MarkFamilyPersistentContact(0), a dry run and
               SetContactWildcardValueAll: 774,144 bonds; the restart
               round trip (the contact file in npz, SetExistingContacts
               on a fresh solver, whose dry run carries every bond); the
               top batch moved up by 4 R with SetOwnerPosition, kernel C
               on the moved block (identical to the plain sweep) finding
               none of the 4,096 cut bonds; 250 steps in chunks of K:
               each refresh re-injects exactly the cut rows, ss.count
               unchanged; launch counts, memory, physics; kernel A on the
               last step's SS (re-injected rows included) and SA
               contact_pass records against its plain version. Both have
               breakdowns, and (a) A's device time on its SS records,
               with the profiled parts at the end
  14 rest    the rest of the API on one DEMSolver of the API's mono
               lattice: (a) UseAdaptiveUpdateFreq, UseAdaptiveBinSize,
               SetCDMaxUpdateFreq(52), 3,200 steps in blocks of 8 chunks:
               one line per block (K, bin factor, ms/step by CUDA events,
               ss.count/cap, growths), each tuner must move and stay on
               its ladder, no contact lost, physics; kernel C identical
               to the plain sweep at the largest bin factor visited and
               at 1.0; (b) tuners off, SaveCheckpoint (time, bytes), 250
               steps, LoadCheckpoint (every tensor bit for bit), the 250
               steps again (within 1e-3 R), the file into a fresh solver
               (bit for bit, a chunk runs); (c) UpdateClumps of 4 layers
               (16,384 clumps, family 2) 0.5 R above the bed's highest
               sphere at 1 m/s down, cap_ss first cut to the live count:
               exact counts,
               1,000 steps with the SS table grown and each growth
               logged at STEP_METRIC, launch counts, peak memory, C on
               the grown table identical, the layer falls; (d)
               PurgeFamily(2): the owners the JAX package's rule keeps
               (family 2 below GetNumClumps()), no sphere on a purged
               owner, positions bit for bit, C after a chunk; (e)
               ChangeClumpSizes of every tenth clump by 0.95: exact
               scaling, 50 steps, |v| bound, physics, C identical; the
               memory getters. Profiled at the end: C's device time at
               the largest bin factor and at 1.0, and (with breakdown)
               the final solver's step and refresh
  15 demos     the 29 examples through dem_engine_tpu_torch.examples'
               load_example on the card, each at the size its JAX test
               builds (tests/torch_scenes.py), Initialize and 4 CD
               chunks: a
               line each (clumps, spheres, triangles, ms/step, contacts,
               the kernels' counts), finite state, no contact lost, the
               example's own invariant (the ball falls, the wheel
               advances by vx t, the anchor holds, ...), C every refresh,
               B every step where the model has a fused variant and none
               otherwise, A every step; the 8 torch twins' force models
               and callables on the card against the same on the CPU
               (1e-5 of the largest value, rule outputs exactly).
               Profiled at the end: launches and device time a step of
               each example
  16 flagship  tools.flagship_wheeldp.run at 524,288 clumps (the tool's
               default), h = 5e-6: the layered GRC terrain on the
               two-class CD in a walled box, 2,000 settle steps
               (--flagship-settle), the contact gate (> 0.5 n); on the
               settled terrain C on both member tables against the plain
               sweep and B on its SS table against its plain version;
               the clump CSV, the restore into a fresh solver with the
               64-triangle wheel (per template the file's counts and
               positions), 3,000 drive steps at slip 0.3
               (--flagship-drive) in 6 chunks with a drawbar line (one
               B-extras query) and the wheel-terrain contact count each:
               the wheel's x advance equals vx t, it sinks and stays above
               the floor, finite state, nothing through the floor, A, B,
               B-extras and C launched. The wheel is still falling onto
               the collapsing bed at these lengths, so it is then set down
               on the terrain under it (lowered until its tread meets a
               sphere, 0.05 m/s faster than that clump falls) for 4 CD
               chunks, which must end with wheel-terrain contacts and
               show an upward load on the wheel, A on SS,
               ST and SA every step; A is held on that step's SS (kernel
               B's), SA and ST rows. Stage times, ms/step, peak memory,
               table counts against capacities. Profiled at the end:
               launches a step and, with breakdown, a drive step and a
               refresh by operation and the refresh's split
  17 mesh      the multi-device layer at world size 1 over NCCL (the box
               has one card): the 262,144-clump bed, Crr = 0, through
               Engine(cfg, mesh) with the spatial refresh on and its
               buckets at a quarter of their auto size, so the first
               refresh takes the OVF_SPATIAL_BUCKET growth (each growth
               printed, the JAX formula's ladder checked); on the
               settled state the spatial pair set identical to kernel
               C's global sweep and to the plain sweep's, and on the
               rows the rank received (padding rows left out as
               non-members) kernel C held row for row to the plain
               sweep, whose kept pairs are that set too; the SA pair
               set identical to the refresh without the mesh; the row
               exchange, its answer and the record fetch over NCCL
               (which one rank's refresh never calls); each rank's rows
               and home rows, and the home split on 2, 4 and 8 ranks;
               one step's wrench and 4 chunks against Engine(cfg) with
               no mesh, bit for bit or else at the parity tolerances
               with the wrench within 1e-6; 250 timed steps and five
               refreshes with and without the mesh (ms/step, refresh ms,
               one refresh's peak memory beyond the state, A twice and B
               once a step, C once a refresh attempt), physics. Profiled
               at the end: a refresh's device time and launches, and
               launches and device time a step with and without the
               mesh, NCCL's share
  18 goldens   the JAX package's engine goldens (tests/torch_behaviour.py,
               the bodies of tests/test_torch_goldens.py) through
               Engine.advance at their own sizes and lengths: the five of
               tests/test_engine_two_spheres.py, slide-to-roll and the
               settling bed (with --phases goldens-long also the
               dumbbell, the clump collision and the mesh bounce; both
               names run all ten); each reading beside the JAX bound,
               steps, ms/step and the launches of A, B and C on the
               path. Then the kernels at the goldens' shapes, their
               launches not counted: C against the plain sweep (pair
               table and count, also at a cap below the count) on the
               two-sphere table (cap_ss 16, one partial tile) in contact
               and on the settling bed's after its 12,000 steps; B with
               A's sums against a float64 evaluation of its plain rows
               there; A against a float64 sum on those SS tables, the
               bed's SA table and the mesh bounce's ST rows in contact,
               and exactly zero for every owner with no live row (also
               on the two-sphere table with no contact)
With every phase run, the line before the last holds the kernels' JSON
record and the one before it the card's name and power limit; the last
line is the JSON verdict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

R_SPHERE = 0.005  # the bed's sphere radius (cases.build_case)
DEVICE = "cuda"
# the poly bed: a fifth of the clumps ratio-3, a fixed plate of 2*16^2
# triangles at the floor's height under the bed's middle
POLY = dict(poly_frac=0.2, with_mesh=True, plate_grid=16,
            plate_z=2 * R_SPHERE)


def fail(msg):
    # on both streams: a caller that keeps only the end of stderr still
    # sees which check failed
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
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
    """What ran on the device during fn() (torch.profiler, the device's
    activity alone: the host ops' records would take key_averages most
    of a profile's time, for rows it drops): a list of (ms, launches,
    name) per kernel or memset, each divided by `per`, largest first;
    empty where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # nothing earlier runs into the profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def phase_device_times(torch, n_clumps, k, kern, reps=10):
    """Device time and launches per call of each kernel from
    torch.profiler over `reps` calls: the segment sums (A, D), one C
    search (and one under the family mask of ``masked_table``) and B on
    the kernels phase's bed, built anew, and the lists
    launch, B-ub and B on the API's table. The bound is held against this
    time, not against the event median, which for a few small launches is
    mostly host time between them. A step's sums must be one zeroing and
    two launches, a C search and the lists each one memset and one
    launch (the poly refresh's two C searches, on its member tables, two
    of each), each other call one launch."""
    from dem_engine_tpu_torch.ops import binning, forces, segred, sweep
    from dem_engine_tpu_torch.ops.fused_force import (hertz_rows_cuda,
                                                      hertz_rows_ub_cuda)
    from dem_engine_tpu_torch.solver import ss_search_inputs

    eng, state, params = kernel_bed(torch, n_clumps)
    n = state.owners.n
    tables, sa, rec_bg = segsum_inputs(eng, state, params)
    cfg = eng.cfg
    q = ss_search_inputs(state, params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device=DEVICE)), cfg.voxel_size)
    S = state.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     S)
    tab_m, mask_m, _ = masked_table(torch, state, q, n_clumps,
                                    cfg.voxel_size)
    h, vs, model = float(params.h), cfg.voxel_size, cfg.force_model
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    s = api_table(n_clumps, k)
    su, n_u = s.state.ss, s.state.owners.n
    ub = s.engine.cfg.uniq_cap
    krec_u = forces.pack_kinematics(s.state.owners, world_omg=True)
    eng_p, st_p, pr_p = kernel_bed(torch, n_clumps, **POLY)
    _, _, _, tabs = member_tables(torch, eng_p, st_p, pr_p)
    cap_p, mask_p = eng_p.cfg.cap_ss, pr_p.family_mask
    c2 = [(t, rows, nb, int(sweep.sweep_table_cuda(t, rows, mask_p, nb,
                                                   cap_p)[2]))
          for t, rows, nb in tabs.values()]
    b_c2 = [bytes_C(t, cap_p, hits) for t, _, _, hits in c2]
    del eng_p, st_p
    for key, tag, fn, launches, bnd in (
            ("A", "A, a step's two pair calls", step_sums_call(tables, n), 3,
             kern["A"]["bound"][0]),
            ("D", "D", lambda: segred.seg_sum_sorted_v1(
                rec_bg, sa.own_b_sorted, n), 1, kern["D"]["bound"][0]),
            ("C", "C, one search", lambda: sweep.sweep_table_cuda(
                tab, S, q["family_mask"], q["nb_cd"], cfg.cap_ss), 2,
             kern["C"]["bound"][0]),
            ("C-mask", "C under the family mask, one search",
             lambda: sweep.sweep_table_cuda(tab_m, S, mask_m, q["nb_cd"],
                                            cfg.cap_ss), 2,
             kern["C"]["masked"]["bound"][0]),
            ("C2", "C, the poly refresh's two member searches",
             lambda: [sweep.sweep_table_cuda(t, rows, mask_p, nb, cap_p)
                      for t, rows, nb, _ in c2], 4,
             bound(sum(b[0] for b in b_c2), sum(b[1] for b in b_c2))[0]),
            ("B", "B, the main path's step launch", lambda: hertz_rows_cuda(
                state.ss, krec, h, vs, model), 1, kern["B"]["bound"][0]),
            ("lists", "the lists launch on the API's table",
             lambda: forces.uniq_layout_cuda(su, n_u, ub), 2,
             bound(*bytes_lists(su, n_u))[0]),
            ("B-ub", "B-ub, the API's step launch", lambda: hertz_rows_ub_cuda(
                su, krec_u, h, vs, model), 1,
             bound(*bytes_B(su, n_u, ub=True))[0]),
            ("B@api", "B on the API's table", lambda: hertz_rows_cuda(
                su, krec_u, h, vs, model), 1, bound(*bytes_B(su, n_u))[0])):
        rows, totals = profiled_calls(torch, fn, reps, launches, tag)
        dev, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
        print(f"[device] {tag}: {dev:.4f} ms in {count} launches ("
              + "; ".join(f"{ms * 1e3:.1f} us x{cnt} {name[:40]}, {seen:g} "
                          f"events in {reps} calls"
                          for (ms, cnt, name), (_, seen, _)
                          in zip(rows, totals))
              + f"), {dev / bnd:.2f}x the bound {bnd:.4f} ms", flush=True)
        kern.setdefault(key, {})
        kern[key]["device_ms"], kern[key]["device_launches"] = dev, count
    kern["C"]["masked"]["device_ms"] = kern.pop("C-mask")["device_ms"]
    del s, su, c2, tabs, tab_m


def profiled_calls(torch, fn, reps, launches, tag, tries=3):
    """torch.profiler over `reps` calls of fn(): per kernel (ms per call,
    launches per call, name) and the raw (ms, events, name) rows. A
    profile must hold, for each kernel, between four fifths and all of
    reps x its launches per call (the profiler now and then drops one of
    the first events of a profile, and at times records nothing), and
    `launches` per call in all, the count the design states. A profile
    short of that is taken again, up to `tries` in all; each miss is
    printed, and the run fails if none holds."""
    for attempt in range(1, tries + 1):
        totals = device_rows(torch, lambda: [fn() for _ in range(reps)])
        # per call: each kernel's mean duration times its launches per call
        rows = [(ms / cnt * round(cnt / reps), round(cnt / reps), name)
                for ms, cnt, name in totals]
        if not totals:
            why = "the profiler recorded no device time"
        else:
            short = [f"{seen:g} events of {name[:40]} in {reps} calls, "
                     f"{per} a call would be {reps * per}"
                     for (_, per, name), (_, seen, _) in zip(rows, totals)
                     if not 0.8 * reps * per <= seen <= reps * per]
            count = sum(r[1] for r in rows)
            why = ("; ".join(short) if short else
                   f"{count} launches, its design states {launches}"
                   if count != launches else None)
        if why is None:
            return rows, totals
        print(f"[device] {tag}: profile {attempt} of {tries}: {why}",
              flush=True)
    fail(f"{tag}: {why}")


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
    from dem_engine_tpu_torch.ops import forces, fused_force, segred, sweep

    return {"A": segred.seg_sum_pair, "B": fused_force.hertz_rows_cuda,
            "B-extras": fused_force.hertz_extras_cuda,
            "B-ub": fused_force.hertz_rows_ub_cuda,
            "C": sweep.sweep_table_cuda, "D": segred.seg_sum_sorted_v1,
            "lists": forces.uniq_layout_cuda}


def reset_counts():
    for w in counters().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in counters().items()}


def set_counts(counts):
    """Puts back the counts `read_counts` gave, so that the launches of a
    check in the middle of a path's run do not count."""
    for k, w in counters().items():
        w.launches = counts[k]


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


def settled_case(torch, n_clumps, steps, update_freq=25, **case):
    """cases.build_case (with `case`, e.g. POLY) after `steps` steps."""
    from dem_engine_tpu_torch import Engine, build_case

    cfg, state, params = build_case(n_clumps, update_freq=update_freq,
                                    device=DEVICE, **case)
    eng = Engine(cfg)
    state = eng.advance(state, params, steps, update_freq)
    return eng, state, params


def kernel_bed(torch, n_clumps, **case):
    """The bed whose tables the kernels are held on: three steps, then
    the next refresh's tables. Returns (engine, state, params)."""
    eng, state, params = settled_case(torch, n_clumps, steps=3, **case)
    state = eng.refresh(state, params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device=DEVICE)))
    return eng, state, params


def member_tables(torch, eng, state, params):
    """The poly bed's two-class search inputs as the refresh builds them:
    (q, tc, {"large": (table, rows, nb), "small": ...}), the member
    tables that kernel C searches, the large one compacted."""
    from dem_engine_tpu_torch.ops import binning
    from dem_engine_tpu_torch.solver import ss_search_inputs, two_class_inputs

    params_k = params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device=DEVICE))
    q = ss_search_inputs(state, params_k, eng.cfg.voxel_size)
    S = state.spheres.n
    small = state.spheres.radius <= params.cls_thr
    tc = two_class_inputs(q, small, params_k, eng.cfg, S)
    tabs = {}
    for name in ("large", "small"):
        pos, reach, own, fam, bs, nb, member = tc[name]
        rows = pos.shape[0]
        tabs[name] = (binning.build_sphere_table(
            pos, reach, own, fam, bs, nb, max(rows, 1), member=member),
            rows, nb)
    return q, tc, small, tabs


def masked_table(torch, state, q, n_clumps, voxel_size):
    """The SS search's sorted table of the kernel bed with its bottom
    layer of clumps in family 1, and the family mask with (1, 1)
    disabled. Returns (table, mask, per-owner bottom-layer flags)."""
    from dem_engine_tpu_torch.ops import binning

    z = state.owners.vox[:n_clumps, 2].double() * voxel_size
    bottom = torch.zeros(state.owners.n, dtype=torch.bool, device=DEVICE)
    bottom[:n_clumps] = z < z.min() + R_SPHERE
    fam = torch.where(bottom[q["owner"].long()], 1,
                      q["family"]).to(q["family"].dtype)
    mask = q["family_mask"].clone()
    mask[1, 1] = False
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     fam, q["bin_size"], q["nb_cd"],
                                     state.spheres.n)
    return tab, mask, bottom


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
                            state.tris, state.anals, params, state.time,
                            cfg.voxel_size, cfg.force_model,
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
    their statics, wildcards and one index (B: own_b; B-ub: uidx, and the
    unique lists and block row starts once), dead rows only their live
    marker (B-ub: not even that); each owner record is read once; every
    row's outputs are written."""
    cap = ss.cap
    live = int((ss.fstat_a[0] >= 0).sum())
    wc = 16 if ss.wildcards else 0
    b = live * (64 + wc + 4) + n_owners * 64
    b += cap * (48 + wc) + (cap * 36 if extras else 0)
    if ub:
        b += ss.uniq_a.shape[0] * 4 + ss.blk_start.shape[0] * 4
    else:
        b += (cap - live) * 4
    return b, live * 250


def bytes_lists(ss, n_owners):
    """Bytes of the lists launch: each live row's own_a, own_b,
    own_b_sorted and perm_b in; uidx for every row, the lists, the block
    row starts and uniq_max out."""
    live = int((ss.own_a >= 0).sum())
    n_blocks = -(-n_owners // 128)
    return (live * 16 + ss.cap * 4 + ss.uniq_a.shape[0] * 4
            + (n_blocks + 1) * 4 + 4), 0


def bytes_C(tab, cap, hits):
    """Bytes and operations of one C search: the sorted table's 32-byte
    records, bin ids and 3-D bin indices, the family mask and the grid
    in; the pair table and the count out; ~10 operations per hit."""
    return tab.n_rows * 48 + 256 * 256 + 12 + cap * 8 + 4, hits * 10


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


def phase_kernels(torch, n_clumps, k):
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
    same = {}
    for cap in (cfg.cap_ss, 1000):  # the bed's capacity, and a count past
        ka, kb, kn = sweep.sweep_table_cuda(tab, S, q["family_mask"],
                                            q["nb_cd"], cap)
        pa, pb, pn = binning.sweep_table(tab, S, q["family_mask"],
                                         q["nb_cd"], cap, mpb)
        same[cap] = (int(kn) == int(pn) and torch.equal(ka, pa)
                     and torch.equal(kb, pb))
    ka, kb, kn = sweep.sweep_table_cuda(tab, S, q["family_mask"],
                                        q["nb_cd"], cfg.cap_ss)
    ms = cuda_ms(torch, lambda: sweep.sweep_table_cuda(
        tab, S, q["family_mask"], q["nb_cd"], cfg.cap_ss))
    pms = cuda_ms(torch, lambda: binning.sweep_table(
        tab, S, q["family_mask"], q["nb_cd"], cfg.cap_ss, mpb))
    bnd = bound(*bytes_C(tab, cfg.cap_ss, int(kn)))
    print(f"[kernels] C sweep: spheres {S} pairs {int(kn)} (plain "
          f"{int(pn)}) max bin occupancy {mpb} identical={same[cfg.cap_ss]}"
          f" (pair table and count), with cap 1000 (count past it) "
          f"identical={same[1000]}; kernel {ms:.3f} ms plain {pms:.3f} ms "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    if not all(same.values()):
        fail("kernel C pair table differs from the plain sweep")
    out["C"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound=bnd,
                    library_ms=None)

    # --- C under a family mask: the bottom layer in family 1, (1, 1) off -
    n_all = int(kn)
    own = q["owner"].long()
    tab_m, mask_m, bottom = masked_table(torch, state, q, n_clumps,
                                         cfg.voxel_size)
    ka, kb, kn = sweep.sweep_table_cuda(tab_m, S, mask_m, q["nb_cd"],
                                        cfg.cap_ss)
    pa, pb, pn = binning.sweep_table(tab_m, S, mask_m, q["nb_cd"],
                                     cfg.cap_ss, mpb)
    same_m = (int(kn) == int(pn) and torch.equal(ka, pa)
              and torch.equal(kb, pb))
    live = ka >= 0
    n11 = int((bottom[own[ka[live].long()]]
               & bottom[own[kb[live].long()]]).sum())
    ms_m = cuda_ms(torch, lambda: sweep.sweep_table_cuda(
        tab_m, S, mask_m, q["nb_cd"], cfg.cap_ss))
    pms_m = cuda_ms(torch, lambda: binning.sweep_table(
        tab_m, S, mask_m, q["nb_cd"], cfg.cap_ss, mpb))
    bnd_m = bound(*bytes_C(tab_m, cfg.cap_ss, int(kn)))
    print(f"[kernels] C under a family mask ({int(bottom.sum())} bottom-"
          f"layer owners in family 1, (1, 1) disabled): pairs {int(kn)} "
          f"(plain {int(pn)}, all-true mask {n_all}), identical={same_m} "
          f"(pair table and count), (1, 1) pairs {n11}; kernel {ms_m:.3f} "
          f"ms plain {pms_m:.3f} ms bound {bnd_m[0]:.4f} ms ({bnd_m[1]})",
          flush=True)
    if not (same_m and n11 == 0 and int(kn) < n_all):
        fail("kernel C under the family mask differs from the plain sweep, "
             "keeps a (1, 1) pair or drops nothing")
    out["C"]["masked"] = dict(ms=ms_m, plain_ms=pms_m, bound=bnd_m,
                              pairs=int(kn), pairs_all=n_all)
    del tab_m, ka, kb, pa, pb

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
        kx, pl = getattr(xk, name), getattr(xp, name)
        errs[name] = rel_err(pl[live].cpu(), kx[live].cpu())
        abs_x = max(abs_x, float((kx - pl).abs().max()))
        if kx[~live].any():
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
          f"identical={identical} (must be); against "
          f"its plain version owner force err {e_f:.2e} torque err "
          f"{e_t:.2e} (tol 2e-4) wildcard err {e_wc:.2e} (tol 1e-3); "
          f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bnd[0]:.4f} ms "
          f"({bnd[1]})", flush=True)
    if not (identical and e_f <= 2e-4 and e_t <= 2e-4 and e_wc <= 1e-3):
        fail("kernel B-ub disagrees with kernel B or its plain version")
    del direct, via_ub, tab_u, tab_pu

    # --- the lists launch, B-ub and B on the API's own (shrunk) table -----
    s_api = api_table(n_clumps, k)
    for tag, t, m, width in (("the bed's table", su, n, ub),
                             ("the API's table", s_api.state.ss,
                              s_api.state.owners.n,
                              s_api.engine.cfg.uniq_cap)):
        got = forces.uniq_layout_cuda(t, m, width)
        want = forces.uniq_layout_plain(t, m, width)
        same_l = {nm: torch.equal(g, w) for nm, g, w in zip(
            ("uidx", "uniq_a", "uniq_max", "blk_start"), got, want)}
        abs_l = max(float((g.double() - w.double()).abs().max())
                    for g, w in zip(got, want))
        ms = cuda_ms(torch, lambda: forces.uniq_layout_cuda(t, m, width))
        pms = cuda_ms(torch, lambda: forces.uniq_layout_plain(t, m, width))
        bnd = bound(*bytes_lists(t, m))
        print(f"[kernels] lists launch on {tag}: rows {t.cap} live "
              f"{int(t.count)}, {n_blocks_of(m)} blocks x {width} slots, "
              f"largest unique count {int(got[2])}, largest block "
              f"{int(got[3].diff().max())} rows; identical to the plain "
              f"_uniq_layout (both layouts) and searchsorted: {same_l}; "
              f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]})", flush=True)
        if not all(same_l.values()):
            fail(f"the lists launch differs from its plain version on {tag}")
        out["lists"] = dict(max_abs_err=abs_l, ms=ms, plain_ms=pms,
                            bound=bnd, library_ms=None)
    krec_t = forces.pack_kinematics(s_api.state.owners, world_omg=True)
    args = (t, krec_t, h, cfg.voxel_size, model)
    ub_rows, b_rows = hertz_rows_ub_cuda(*args), hertz_rows_cuda(*args)
    identical = all(torch.equal(a, b) for a, b in zip(ub_rows, b_rows))
    live_t = t.fstat_a[0] >= 0
    oat = torch.where(live_t, t.own_a, 0).long()
    wct = torch.stack([t.wildcards[nm] for nm in names])
    plain_u = hertz_rows(t.fstat_a, wct, krec_t[oat],
                         uniq_records(t, krec_t), h, cfg.voxel_size, True)
    abs_u = max(float((a - b).abs().max()) for a, b in zip(plain_u, ub_rows))
    ms = cuda_ms(torch, lambda: hertz_rows_ub_cuda(*args))
    ms_b = cuda_ms(torch, lambda: hertz_rows_cuda(*args))
    pms = cuda_ms(torch, lambda: hertz_rows(
        t.fstat_a, wct, krec_t[oat], uniq_records(t, krec_t), h,
        cfg.voxel_size, True))
    bnd, bnd_b = bound(*bytes_B(t, m, ub=True)), bound(*bytes_B(t, m))
    print(f"[kernels] B-ub on the API's table: rows {t.cap} live "
          f"{int(t.count)}; against kernel B identical={identical}, against "
          f"its plain version max abs err {abs_u:.3e}; B-ub {ms:.3f} ms "
          f"(bound {bnd[0]:.4f} ms), B {ms_b:.3f} ms (bound {bnd_b[0]:.4f} "
          f"ms) by events; plain {pms:.3f} ms", flush=True)
    if not identical:
        fail("kernel B-ub differs from kernel B on the API's table")
    out["B-ub"] = dict(max_abs_err=abs_u, ms=ms, plain_ms=pms, bound=bnd,
                       library_ms=None)
    del eng_u, st_u, su, t, ub_rows, b_rows, plain_u, s_api

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
        kd, k_spill = segred.seg_sum_sorted_v1(rec, ids, n)
        pl, p_spill = segred.seg_sum_v1_plain(rec, ids, n)
        exact, _ = segred.seg_sum_v1_plain(rec.double(), ids, n)
        scale = max(float(exact.abs().max()), 1e-30)
        errs_d.append(float((kd.double() - exact).abs().max()) / scale)
        abs_d = max(abs_d, float((kd - pl).abs().max()))
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
    del eng, state, tab, tables, sa, rec_bg, calls, lib, lib_d
    torch.cuda.empty_cache()
    phase_kernels_poly(torch, n_clumps, out)
    return out


def phase_kernels_poly(torch, n_clumps, out):
    """On the poly bed: kernel C on both member tables of its two-class
    CD (the compacted large class, whose dead rows and the small class's
    left-out spheres fill the sentinel tail), each held row for row to
    the plain sweep at the bed's capacity and at a count past 1000; and
    kernel A on its ST table, held to the float64 sum."""
    from dem_engine_tpu_torch.ops import forces, segred

    eng, state, params = kernel_bed(torch, n_clumps, **POLY)
    cfg, n = eng.cfg, state.owners.n
    _, _, _, tabs = member_tables(torch, eng, state, params)
    c_on_members(torch, tabs, params.family_mask, cfg.cap_ss,
                 "[kernels] C on the poly bed's")

    st = state.st
    p = forces.contact_pass("st", st, state.owners, state.spheres,
                            state.tris, state.anals, params, state.time,
                            cfg.voxel_size, cfg.force_model)
    got = segred.seg_sum_pair(p["rec_a"], st.own_a, p["rec_b"],
                              st.own_b_sorted, st.perm_b, n)
    exact = (segred.seg_sum_plain(p["rec_a"].double(), st.own_a, n)
             + segred.seg_sum_plain(p["rec_b"].double(), st.own_b_sorted, n,
                                    perm=st.perm_b))
    err = float((got.double() - exact).abs().max()) / max(
        float(exact.abs().max()), 1e-30)
    print(f"[kernels] A on the poly bed's ST table: rows {st.cap} live "
          f"{int(st.count)} on {state.tris.n} triangles; error against the "
          f"float64 sum {err:.2e} (tol 1e-5)", flush=True)
    if not (err <= 1e-5 and int(st.count) > 0):
        fail("kernel A disagrees with the float64 sum on the ST table")
    out["A"]["st_err"] = err
    del eng, state, tabs
    torch.cuda.empty_cache()


def c_on_members(torch, tabs, mask, cap_ss, what):
    """Kernel C on each member table of `tabs` (from `member_tables`),
    held row for row to the plain sweep at capacity `cap_ss` and at a
    count past 1000; events, plain and the bound printed after `what`.
    Returns {class: (kernel ms, plain ms, bound, pairs)}."""
    from dem_engine_tpu_torch.ops import binning, sweep

    out = {}
    for name, (tab, rows, nb) in tabs.items():
        mpb = int(tab.max_occ)
        real = int((tab.sorted_bin != binning.SENTINEL_BIN).sum())
        same = {}
        for cap in (cap_ss, 1000):
            ka, kb, kn = sweep.sweep_table_cuda(tab, rows, mask, nb, cap)
            pa, pb, pn = binning.sweep_table(tab, rows, mask, nb, cap, mpb)
            same[cap] = (int(kn) == int(pn) and torch.equal(ka, pa)
                         and torch.equal(kb, pb))
        ms = cuda_ms(torch, lambda: sweep.sweep_table_cuda(
            tab, rows, mask, nb, cap_ss))
        pms = cuda_ms(torch, lambda: binning.sweep_table(
            tab, rows, mask, nb, cap_ss, mpb))
        bnd = bound(*bytes_C(tab, cap_ss, int(pn)))
        print(f"{what} {name}-class member table: "
              f"{rows} rows, {real} real (the rest sentinel), pairs "
              f"{int(pn)}, max bin occupancy {mpb}; identical to the plain "
              f"sweep (pair table and count) at cap {cap_ss}: "
              f"{same[cap_ss]}, at cap 1000 (count past it): "
              f"{same[1000]}; kernel {ms:.3f} ms plain {pms:.3f} ms bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        if not all(same.values()) or int(pn) <= 1000:
            fail(f"kernel C differs from the plain sweep on the {name}-"
                 "class member table")
        out[name] = (ms, pms, bnd, int(pn))
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

    # the poly bed with its plate: one refresh, pair sets
    sets = {}
    for dev in (DEVICE, "cpu"):
        cfg, st, pr = build_case(n_clumps, update_freq=10, device=dev,
                                 **POLY)
        st = Engine(cfg).refresh(st, pr.replace(max_drift=torch.tensor(
            10, dtype=torch.int32, device=dev)))
        sets[dev] = [_pair_set(t) for t in (st.ss, st.st, st.sa)]
    same = [a == b for a, b in zip(sets[DEVICE], sets["cpu"])]
    print(f"[parity] {n_clumps}-clump poly bed with its plate, one refresh: "
          f"SS pairs {len(sets[DEVICE][0])} ST pairs {len(sets[DEVICE][1])} "
          f"SA pairs {len(sets[DEVICE][2])}; card and CPU sets equal (SS, "
          f"ST, SA): {same}", flush=True)
    if not (all(same) and len(sets["cpu"][1]) > 0):
        fail("the card's poly refresh disagrees with the CPU's")

    # the families scene (rolling resistance off, as the bed above): one
    # chunk of K = 10 through DEMSolver, card against CPU
    k_p, res = 10, {}
    for dev in (DEVICE, "cpu"):
        s, _, _ = families_solver(n_clumps, k_p, k_p * API_H, crr=0.0,
                                  device=dev)
        s.DoDynamics(k_p * API_H)
        o = s.state.owners
        res[dev] = dict(
            pairs=[_pair_set(t) for t in (s.state.ss, s.state.st,
                                          s.state.sa)],
            vel=o.vel.cpu().numpy(), omg=o.omg.cpu().numpy(),
            pos=s.GetOwnerPosition(), fam=s.GetOwnerFamily(),
            vs=s._voxel_size)
        del s
    g, c = res[DEVICE], res["cpu"]
    same = [a == b for a, b in zip(g["pairs"], c["pairs"])]
    e_v, e_o = rel_err(c["vel"], g["vel"]), rel_err(c["omg"], g["omg"])
    e_p = float(np.abs(c["pos"] - g["pos"]).max() / c["vs"])
    fam_eq = bool(np.array_equal(g["fam"], c["fam"]))
    print(f"[parity] {n_clumps}-clump families scene (fixed bottom layer, "
          f"prescribed plate, rule, added acceleration; Crr=0), one chunk "
          f"of {k_p}: SS pairs {len(g['pairs'][0])} ST pairs "
          f"{len(g['pairs'][1])} SA pairs {len(g['pairs'][2])}; sets "
          f"equal (SS, ST, SA): {same}; family-3 owners "
          f"{int((g['fam'] == 3).sum())}, families equal {fam_eq}; vel err "
          f"{e_v:.2e} omg err {e_o:.2e} position err {e_p:.2e} voxel (tol "
          f"2e-4, 2e-4, 1e-3)", flush=True)
    if not (all(same) and fam_eq and e_v <= 2e-4 and e_o <= 2e-4
            and e_p <= 1e-3 and len(g["pairs"][1]) > 0
            and (g["fam"] == 3).any()):
        fail("the card's families scene disagrees with the CPU's")


def physics(torch, state, voxel_size, tag, floor=2 * R_SPHERE):
    """Finite state, no sphere centre within half its radius of the floor
    plane (at `floor` above the domain's lower corner), SS contacts
    present; with triangles, ST contacts present and no sphere centre
    over the plate within half its radius of the plate's plane (the plate
    lies flat: nothing went through it)."""
    from dem_engine_tpu_torch.solver import sphere_world_pos, tri_world_nodes

    o, sph = state.owners, state.spheres
    finite = all(bool(torch.isfinite(x).all())
                 for x in (o.vel, o.omg, o.loc, o.quat))
    pos = sphere_world_pos(o, sph, voxel_size)
    min_gap = float(((pos[:, 2] - floor) / sph.radius).min())
    ok = finite and min_gap > 0.5 and int(state.ss.count) > 0
    msg = (f"[{tag}] physics: finite={finite} lowest sphere centre "
           f"{min_gap:.3f} radii above the floor (need > 0.5), ss.count "
           f"{int(state.ss.count)} > 0")
    if state.tris.n:
        nodes = tri_world_nodes(o, state.tris, voxel_size).reshape(-1, 3)
        lo, hi = nodes.min(0).values, nodes.max(0).values
        over = ((pos[:, 0] > lo[0]) & (pos[:, 0] < hi[0])
                & (pos[:, 1] > lo[1]) & (pos[:, 1] < hi[1]))
        gap = float(((pos[over, 2] - nodes[:, 2].mean()).abs()
                     / sph.radius[over]).min())
        ok &= int(state.st.count) > 0 and gap > 0.5 and bool(
            (hi[2] - lo[2]) < R_SPHERE)
        msg += (f"; st.count {int(state.st.count)} > 0, {int(over.sum())} "
                f"sphere centres over the plate, the nearest {gap:.3f} "
                f"radii from its plane (need > 0.5), plate tilt "
                f"{float(hi[2] - lo[2]) / R_SPHERE:.3f} R")
    print(msg, flush=True)
    if not ok:
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
              "C": refreshes, "D": 0, "lists": 0}
    print(f"[main] launches {launches}, expected {expect} "
          f"({refreshes} refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the main path")
    physics(torch, state, eng.cfg.voxel_size, "main")
    return launches


def poly_counts(eng, state, params):
    """The poly path's table counts against their capacities, and the
    large class against the rows of its compaction."""
    from dem_engine_tpu_torch.solver import _cross_lcap

    cfg = eng.cfg
    n_large = int((state.spheres.radius > params.cls_thr).sum())
    return (f"ss.count {int(state.ss.count)} (cap {cfg.cap_ss}) st.count "
            f"{int(state.st.count)} (cap {cfg.cap_st}) sa.count "
            f"{int(state.sa.count)} (cap {cfg.cap_sa}); large class "
            f"{n_large} spheres against lcap "
            f"{_cross_lcap(cfg, state.spheres.n)}; ST sweep max_per_bin "
            f"{cfg.max_per_bin}, cross_mpb {cfg.cross_mpb}")


def phase_poly(torch, n_clumps, k, warm, steps):
    """Engine.advance on the poly bed with its plate: the two-class CD
    (C twice a refresh) and the ST table (A three times a step)."""
    eng, state, params = settled_case(torch, n_clumps, warm, update_freq=k,
                                      **POLY)
    if not eng.cfg.cd_two_class or state.tris.n != 2 * 16 * 16:
        fail("the poly bed is not two-class with its 512-triangle plate")
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
    print(f"[poly] {n_clumps} clumps ({state.spheres.n} spheres, "
          f"{state.tris.n} triangles), K={k}, {steps} steps after {warm} "
          f"warm-up: {dt * 1e3 / steps:.3f} ms/step, "
          f"{n_clumps * steps / dt:.4g} clump-steps/s; "
          f"{poly_counts(eng, state, params)}; peak memory "
          f"{mem / 2**30:.2f} GiB", flush=True)
    expect = {"A": 3 * steps, "B": steps, "B-extras": 0, "B-ub": 0,
              "C": 2 * refreshes, "D": 0, "lists": 0}
    print(f"[poly] launches {launches}, expected {expect} "
          f"({refreshes} refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the poly path")
    physics(torch, state, eng.cfg.voxel_size, "poly")
    return launches


def phase_breakdown(torch, eng, state, params, k, tag="breakdown"):
    """Where one chunk's time goes: the refresh and the K steps timed
    apart (synchronised host clock), then the device time of 5 steps by
    operation from torch.profiler, against their unprofiled wall time,
    and of one more refresh by operation."""
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
    rows = device_rows(torch, lambda: eng.refresh(state, params_k))
    print(f"[{tag}] one refresh: device busy {sum(r[0] for r in rows):.3f} "
          f"ms in {sum(r[1] for r in rows):g} launches", flush=True)
    for ms, cnt, name in rows[:8]:
        print(f"[{tag}]   {ms:.3f} ms/refresh  x{cnt:g}  {name[:70]}",
              flush=True)


def poly_refresh_split(torch, eng, state, params, k):
    """One poly refresh's device time (torch.profiler, the mean of five)
    against its parts, each run alone on the same inputs: kernel C on the two member tables,
    the cross search (entries and small-large pairs), the ST search (its
    single-grid table and the two-stage sweep); the rest is the table
    builds, the history carry and the finalizing sorts."""
    from dem_engine_tpu_torch.ops import sweep
    from dem_engine_tpu_torch.solver import cross_pairs, st_pairs

    params_k = params.replace(max_drift=torch.tensor(
        k, dtype=torch.int32, device=DEVICE))
    q, tc, small, tabs = member_tables(torch, eng, state, params)
    cfg, S = eng.cfg, state.spheres.n

    def dev(fn, reps=5):
        # per call over `reps` calls: the profiler now and then drops one
        # of the first events of a profile, and at times a whole short
        # profile: up to three tries
        for _ in range(3):
            rows = device_rows(torch, lambda: [fn() for _ in range(reps)],
                               per=reps)
            if rows:
                return sum(r[0] for r in rows), sum(r[1] for r in rows)
        return None

    parts = {
        "refresh": dev(lambda: eng.refresh(state, params_k)),
        "C x2": dev(lambda: [sweep.sweep_table_cuda(
            t, rows, q["family_mask"], nb, cfg.cap_ss)
            for t, rows, nb in tabs.values()], reps=10),
        "cross search": dev(lambda: cross_pairs(q, tc, small, cfg, S)),
        "ST search": dev(lambda: st_pairs(state, params_k, cfg, q, None)),
    }
    line = "; ".join(f"{kk} not measured (no device time recorded)"
                     if v is None else f"{kk} {v[0]:.3f} ms in {v[1]:g} "
                     "launches" for kk, v in parts.items())
    if all(parts.values()):
        total = parts["refresh"][0]
        rest = total - sum(v[0] for kk, v in parts.items()
                           if kk != "refresh")
        line += f"; the rest {rest:.3f} ms ({rest / total:.2f} of it)"
    print(f"[poly breakdown] one refresh's device time: {line}", flush=True)


API_H = 5e-6  # the API runs' step size
API_DEFAULT_UNIQ = 0  # DEMSolver's unique-fetch width on the card
# the API's default first (it also runs the contact query), then the
# other setting, which drives kernel B-ub and the lists launch
API_RUNS = (("default, unique fetch off", None), ("unique fetch 512", 512))


def api_table(n_clumps, k):
    """A DEMSolver with unique fetch at 512 after one chunk (its first
    refresh and maybe_shrink): its SS table is the one the API's steps
    run kernel B-ub on."""
    s = api_solver(n_clumps, k, 512)
    s.DoDynamics(k * API_H)
    return s


def api_solver(n_clumps, k, uniq, name=None):
    """DEMSolver on the bench bed through its public calls: the clump
    template (named `name`, if given) and lattice of cases.build_case,
    the floor by AddBCPlane."""
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
    if name is not None:
        tmpl.AssignName(name)
    s.AddClumps(tmpl, geo["pos"] - dims / 2)
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(5e-6)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    if uniq is not None:
        s.SetFusedUniqueFetch(uniq)
    s.Initialize()
    return s


def api_poly_solver(n_clumps, k):
    """DEMSolver on the poly bed's lattice through its public calls: two
    clump types (R and 3R), the floor by AddBCPlane, the two-class CD left
    to Initialize's radius rule, and a free plate of 2*16^2 triangles
    (12R square, the mass of a 12R x 12R x R slab) laid on the bed's top
    layer by AddWavefrontMeshObject."""
    from dem_engine_tpu_torch import DEMSolver
    from dem_engine_tpu_torch.cases import R, bed_geometry, plate_mesh
    from dem_engine_tpu_torch.structs import DEMMeshConnected

    geo = bed_geometry(n_clumps, POLY["poly_frac"])
    dims, pos, scale = geo["dims"], geo["pos"], geo["scale"]
    s = DEMSolver(device=DEVICE)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e9, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.01})
    tmpl = {f: s.LoadClumpType(geo["mass"] * f**3, geo["moi"] * f**5,
                               [R * f] * 3, geo["rel"] * f, mat)
            for f in (1.0, 3.0)}
    s.AddClumps([tmpl[f] for f in scale], pos - dims / 2)
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    verts, faces = plate_mesh(POLY["plate_grid"])
    plate = DEMMeshConnected(vertices=verts, faces=faces)
    m = 2600.0 * (12 * R) ** 2 * R
    plate.SetMass(m)
    plate.SetMOI([m * (12 * R) ** 2 / 12] * 2 + [m * (12 * R) ** 2 / 6])
    top = pos[:, 2] + 2 * R * scale  # each clump's highest point
    layer = top > top.max() - R
    plate.SetInitPos(np.asarray([pos[layer, 0].mean(), pos[layer, 1].mean(),
                                 top.max() - 1e-3 * R]) - dims / 2)
    s.AddWavefrontMeshObject(plate, mat)
    s.SetInitTimeStep(API_H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    s.Initialize()
    return s


def phase_api_poly(torch, n_clumps, k, steps):
    """The poly path through DEMSolver: DoDynamics timed after one
    warm-up chunk, then one GetContactDetailedInfo with its ST block.
    Returns the launch counts of the steps."""
    h = API_H
    torch.cuda.empty_cache()
    s = api_poly_solver(n_clumps, k)
    cfg = s.engine.cfg
    if not cfg.cd_two_class or s.state.tris.n != 512:
        fail("the API's poly bed did not take the two-class CD and plate")
    s.DoDynamics(k * h)
    attempts0 = s.engine.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s.DoDynamics(steps * h)
    dt = time.perf_counter() - t0
    launches = read_counts()
    refreshes = s.engine.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    print(f"[api] poly path: {s.GetNumClumps()} clumps, "
          f"{s.GetNumSpheres()} spheres, {s.state.tris.n} triangles of a "
          f"free plate, two-class CD by the radius rule (cls_thr "
          f"{float(s.params.cls_thr):.4g}), K={k}, {steps} steps: "
          f"{dt * 1e3 / steps:.3f} ms/step, "
          f"{n_clumps * steps / dt:.4g} clump-steps/s; "
          f"{poly_counts(s.engine, s.state, s.params)}; peak memory "
          f"{mem / 2**30:.2f} GiB", flush=True)
    expect = {"A": 3 * steps, "B": steps, "B-extras": 0, "B-ub": 0,
              "C": 2 * refreshes, "D": 0, "lists": 0}
    print(f"[api] poly launches {launches}, expected {expect} "
          f"({refreshes} refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the API's poly path")
    physics(torch, s.state, s.engine.cfg.voxel_size, "api poly")
    reset_counts()
    info = {b["kind"]: b for b in s.GetContactDetailedInfo()}
    q = read_counts()
    finite = all(np.isfinite(b[f]).all() for b in info.values()
                 for f in ("force", "torque_only", "point"))
    n_st = len(info["ST"]["idA"]) if "ST" in info else 0
    print(f"[api] poly GetContactDetailedInfo: kinds {sorted(info)}, ST "
          f"rows {n_st}, finite={finite}, launches {q}", flush=True)
    if not (q["B-extras"] == 1 and n_st == int(s.state.st.count) > 0
            and finite and {"SS", "SA"} <= set(info)):
        fail("the poly contact query did not return its ST block")
    del s
    torch.cuda.empty_cache()
    return launches


def phase_uniq(torch, n_clumps, k, runs=5):
    """Does unique fetch pay on this card? The device time of one
    DoDynamics chunk (refresh + K steps; torch.profiler) of two solvers
    on the same bed, unique fetch at 512 and off, in `runs` alternating
    rounds. By the rule written before the first run, 512 is ahead when
    its mean is lower than off's by more than the larger of the two
    spreads (max - min); only then does the API's default stay 512."""
    solvers = {}
    for label, uniq in (("512", 512), ("off", 0)):
        torch.cuda.empty_cache()
        solvers[label] = api_solver(n_clumps, k, uniq)
        solvers[label].DoDynamics(k * API_H)  # first refresh and shrink
    dev = {label: [] for label in solvers}
    for _ in range(runs):
        for label, s in solvers.items():
            for attempt in range(3):  # at times a profile records nothing
                rows = device_rows(torch,
                                   lambda s=s: s.DoDynamics(k * API_H))
                if rows:
                    break
                print(f"[uniq] {label}: profile {attempt + 1} of 3 recorded "
                      "no device time", flush=True)
            else:
                fail("the profiler recorded no device time for a chunk")
            dev[label].append(sum(r[0] for r in rows))
    mean = {lb: float(np.mean(v)) for lb, v in dev.items()}
    spread = max(max(v) - min(v) for v in dev.values())
    ahead = mean["off"] - mean["512"] > spread
    print(f"[uniq] device ms of one chunk (refresh + {k} steps), {runs} "
          f"alternating rounds: "
          + "; ".join(f"{lb}: " + ", ".join(f"{x:.3f}" for x in v)
                      + f" (mean {mean[lb]:.3f})" for lb, v in dev.items())
          + f"; larger spread {spread:.3f} ms; 512 ahead by the rule: "
          f"{ahead}", flush=True)
    del solvers
    torch.cuda.empty_cache()


def phase_api(torch, n_clumps, k, steps):
    """DoDynamics through DEMSolver, with unique fetch at its default and
    at the other setting; then one contact query on the default run.
    Returns the launch counts of the default run's steps ("steps"), of
    the run with unique fetch on ("ub") and of the query."""
    h = API_H
    counts = {}
    for i, (label, uniq) in enumerate(API_RUNS):
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
        on = cfg.uniq_cap > 0
        expect = {"A": 2 * steps, "B": 0 if on else steps, "B-extras": 0,
                  "B-ub": steps if on else 0, "C": refreshes, "D": 0,
                  "lists": refreshes if on else 0}
        print(f"[api] launches {launches}, expected {expect} "
              f"({refreshes} refresh attempts)", flush=True)
        if launches != expect or refreshes < steps // k:
            fail(f"launch counts do not match the API path ({label})")
        if on != ((API_DEFAULT_UNIQ if uniq is None else uniq) > 0):
            fail(f"unique fetch is {'on' if on else 'off'} in the run "
                 f"{label!r}")
        physics(torch, st, cfg.voxel_size, "api")
        if on:
            counts["ub"] = launches
        if i == 0:
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


# the families path: the plate sinks at -PLATE_V * (1 - cos(2 pi t / T)),
# T the phase's run, by PLATE_V * T in all (0.12 R over 300 steps)
PLATE_V = 0.4


def families_solver(n_clumps, k, period, crr=0.01, device=None):
    """DEMSolver on the API's mono lattice with families, through public
    calls: the bottom layer in family 1 (SetFamilies) with
    SetFamilyFixed(1) and DisableContactBetweenFamilies(1, 1); the
    2*16^2-triangle plate in family 2 laid on the top layer, pressed down
    at f(t) = -PLATE_V * (1 - cos(2 pi t / period)) (a torch callable)
    with no spin; ChangeFamilyWhen(0, 3) for the top layer's clumps under
    the plate's footprint, and an added 9.81 m/s^2 down on family 3.
    Returns (solver, f as a numpy function, the rule as a numpy function
    of LBF-relative clump centres)."""
    import torch

    from dem_engine_tpu_torch import DEMSolver
    from dem_engine_tpu_torch.cases import R, bed_geometry, plate_mesh
    from dem_engine_tpu_torch.structs import DEMMeshConnected

    geo = bed_geometry(n_clumps)
    dims, pos = geo["dims"], geo["pos"]
    s = DEMSolver(device=device or DEVICE)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e9, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": crr})
    tmpl = s.LoadClumpType(geo["mass"], geo["moi"], [R] * 3, geo["rel"], mat)
    batch = s.AddClumps(tmpl, pos - dims / 2)
    z = pos[:, 2]
    batch.SetFamilies(np.where(z < z.min() + R, 1, 0))
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    verts, faces = plate_mesh(POLY["plate_grid"])
    plate = DEMMeshConnected(vertices=verts, faces=faces)
    plate.SetFamily(2)
    top = z + 2 * R  # each clump's highest point
    layer = top > top.max() - R
    cx, cy = pos[layer, 0].mean(), pos[layer, 1].mean()
    plate.SetInitPos(np.asarray([cx, cy, top.max() - 1e-3 * R]) - dims / 2)
    s.AddWavefrontMeshObject(plate, mat)
    s.SetFamilyFixed(1)
    s.DisableContactBetweenFamilies(1, 1)
    w = 2 * np.pi / period
    s.SetFamilyPrescribedLinVel(
        2, 0, 0, lambda t: -PLATE_V * (1 - torch.cos(w * t)))
    s.SetFamilyPrescribedAngVel(2, 0, 0, 0)
    z_thr = z.max() - 2 * R  # half a layer below the top layer's centres

    def rule(v, t):
        return ((v.pos[:, 2] > z_thr) & ((v.pos[:, 0] - cx).abs() < 6 * R)
                & ((v.pos[:, 1] - cy).abs() < 6 * R))

    def rule_host(p):
        return ((p[:, 2] > z_thr) & (np.abs(p[:, 0] - cx) < 6 * R)
                & (np.abs(p[:, 1] - cy) < 6 * R))

    s.ChangeFamilyWhen(0, 3, rule)
    s.AddFamilyPrescribedAcc(3, 0, 0, -9.81)
    s.SetInitTimeStep(API_H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    s.Initialize()
    return s, (lambda t: -PLATE_V * (1 - np.cos(w * t))), rule_host


def owner_families(s, ids):
    """Families of the owners of sphere ids `ids`."""
    own = s.state.spheres.owner.cpu().numpy()
    return s.GetOwnerFamily()[own[np.asarray(ids)]]


def phase_families(torch, n_clumps, k, steps):
    """The families path through DEMSolver (``families_solver``): one
    step with the rule held to the host's count, the rest of a warm-up
    chunk, `steps` timed steps (launch counts, memory), K steps under
    torch.cuda.set_sync_debug_mode("error") after a refresh outside
    that window; then the fixed layer, the plate's path against the
    integral of f over the steps' f32 times, the contact query's SS
    pairs and the physics. Returns the launch counts of the timed
    steps."""
    from dem_engine_tpu_torch.solver import run_steps

    h = API_H
    n_total = 2 * k + steps
    torch.cuda.empty_cache()
    s, f, rule_host = families_solver(n_clumps, k, n_total * h)
    n = s.GetNumClumps()
    o = s.state.owners
    fam0 = s.GetOwnerFamily()
    fixed = fam0 == 1
    plate = s._meshes[0].owner_id
    keep = {name: getattr(o, name).cpu().numpy() for name in
            ("vox", "loc", "quat")}
    pos0 = s.GetOwnerPosition()
    # the rule's step: the top layer's clumps under the plate go 0 -> 3
    want3 = int((rule_host(pos0[:n] - s._lbf) & (fam0[:n] == 0)).sum())
    s.DoDynamics(h)
    got3 = int((s.GetOwnerFamily() == 3).sum())
    s.DoDynamics((k - 1) * h)
    attempts0 = s.engine.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s.DoDynamics(steps * h)
    dt = time.perf_counter() - t0
    launches = read_counts()
    refreshes = s.engine.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    # K steps under sync-debug "error"; the refresh reads its overflow
    # word by design, so it runs before the window
    params_k = s.params.replace(max_drift=torch.tensor(
        k, dtype=torch.int32, device=DEVICE))
    state = s.engine.refresh(s.state, params_k)
    h32 = float(s.params.h)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = run_steps(state, params_k, s.engine.cfg, k, h=h32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    s.state = state
    print(f"[families] {n} clumps ({int(fixed.sum())} fixed in family 1, "
          f"{got3} moved to family 3 by the rule, host count {want3}), a "
          f"{s.state.tris.n}-triangle plate in family 2, K={k}, {steps} "
          f"steps after {k}: {dt * 1e3 / steps:.3f} ms/step, "
          f"{n * steps / dt:.4g} clump-steps/s; peak memory "
          f"{mem / 2**30:.2f} GiB; ss.count {int(s.state.ss.count)} "
          f"st.count {int(s.state.st.count)} sa.count "
          f"{int(s.state.sa.count)}; {k} steps under sync-debug 'error' "
          "raised nothing", flush=True)
    expect = {"A": 3 * steps, "B": steps, "B-extras": 0, "B-ub": 0,
              "C": refreshes, "D": 0, "lists": 0}
    print(f"[families] launches {launches}, expected {expect} "
          f"({refreshes} refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the families path")
    if not got3 == want3 > 0:
        fail(f"the rule moved {got3} owners to family 3, the host counts "
             f"{want3}")
    # the fixed layer: pose bit for bit, no velocity
    o = s.state.owners
    same = {name: bool(np.array_equal(getattr(o, name).cpu().numpy()[fixed],
                                      keep[name][fixed]))
            for name in keep}
    still = not (o.vel[torch.from_numpy(fixed).to(DEVICE)].any()
                 or o.omg[torch.from_numpy(fixed).to(DEVICE)].any())
    # the plate: dz against the integral of f over the steps' f32 times
    t32, dz = np.float32(0.0), 0.0
    for _ in range(n_total):
        dz += f(np.float64(t32)) * h
        t32 = np.float32(t32 + np.float32(h))
    moved = s.GetOwnerPosition()[plate] - pos0[plate]
    tol = s._voxel_size + n_total * h * PLATE_V * 2 * 1e-6
    q_same = np.array_equal(s.GetOwnerOriQ()[plate], keep["quat"][plate])
    info = {b["kind"]: b for b in s.GetContactDetailedInfo()}
    ss = info.get("SS")
    n11 = int(((owner_families(s, ss["idA"]) == 1)
               & (owner_families(s, ss["idB"]) == 1)).sum()) if ss else -1
    print(f"[families] family 1 after {n_total} steps: vox, loc, quat "
          f"bit-identical {same}, vel and omg exactly 0: {still}; plate "
          f"dz {moved[2]:.9e} m against the integral of f "
          f"{dz:.9e} m (|diff| {abs(moved[2] - dz):.3e}, tol {tol:.3e}: a "
          f"voxel and f32 evaluation), x, y moved {moved[:2]}, quaternion "
          f"unchanged {q_same}; SS contacts in the query "
          f"{len(ss['idA']) if ss else 0}, between two family-1 owners "
          f"{n11}; kinds {sorted(info)}", flush=True)
    if not (all(same.values()) and still):
        fail("a fixed owner moved")
    if not (abs(moved[2] - dz) <= tol and not moved[:2].any() and q_same
            and dz < 0):
        fail("the prescribed plate left its path")
    if n11 != 0 or "ST" not in info:
        fail("the contact query holds a (1, 1) pair or no ST block")
    physics(torch, s.state, s.engine.cfg.voxel_size, "families")
    del s, state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the output path: inspectors, clump and contact files, stage timing
# ---------------------------------------------------------------------------

QUANTITIES = tuple(f"clump_{m}_{a}" for m in ("max", "min") for a in "xyz") + (
    "clump_max_absv", "clump_absv", "clump_kinetic_energy", "clump_mass",
    "clump_volume", "clump_count")


def gap_cut(vals, frac, window=0.1):
    """A cut between two of `vals` near their `frac` quantile: the middle
    of the widest gap between sorted values within `window` of the count
    of it, so that no value sits near the cut (a bed's contact forces
    crowd closer than an f32 ulp around their median, so a narrow window
    can hold gaps of one ulp)."""
    v = np.sort(np.asarray(vals, np.float64))
    i = int(frac * (len(v) - 1))
    w = max(int(window * len(v)), 1)
    lo, hi = max(i - w, 0), min(i + w + 1, len(v))
    g = lo + int(np.argmax(np.diff(v[lo:hi])))
    return 0.5 * (v[g] + v[g + 1])


def inspect_ref(s, q, mask, host):
    """An inspector quantity in float64 numpy over the copied state
    `host`, the spheres in `mask`."""
    from dem_engine_tpu_torch.defines import RESERVED_FAMILY

    ax = {"x": 0, "y": 1, "z": 2}.get(q[-1])
    if q.startswith("clump_max_") and q != "clump_max_absv":
        return float((host["pos"][mask, ax] + host["r"][mask]).max())
    if q.startswith("clump_min_"):
        return float((host["pos"][mask, ax] - host["r"][mask]).min())
    n = len(host["mass"])
    omask = np.zeros(n, bool)
    omask[np.unique(host["own"][mask])] = True
    omask &= (host["family"] != RESERVED_FAMILY) & (np.arange(n)
                                                     < s.GetNumClumps())
    absv = np.linalg.norm(host["vel"][omask], axis=1)
    return {
        "clump_max_absv": lambda: absv.max(),
        "clump_absv": lambda: absv.mean(),
        "clump_kinetic_energy": lambda: (
            0.5 * host["mass"][omask] * (host["vel"][omask] ** 2).sum(1)
            + 0.5 * (host["moi"][omask] * host["omg"][omask] ** 2).sum(1)
        ).sum(),
        "clump_mass": lambda: host["mass"][omask].sum(),
        "clump_volume": lambda: s._owner_volume[omask[:len(
            s._owner_volume)]].sum(),
        "clump_count": lambda: float(omask.sum()),
    }[q]()


def output_inspectors(torch, s):
    """Every quantity in four region kinds (none, a box, a ball, the box
    as a host callable) against float64 numpy over the copied state;
    host microseconds per GetValue."""
    import warnings

    from dem_engine_tpu_torch import BoxRegion, DEMInspector, SphereRegion

    st = s.state
    o, sph = st.owners, st.spheres
    own = sph.owner.cpu().numpy()
    q64 = o.quat.cpu().numpy().astype(np.float64)[own]
    rel = sph.relpos.cpu().numpy().astype(np.float64)
    t = 2.0 * np.cross(q64[:, 1:], rel)
    rot = rel + q64[:, :1] * t + np.cross(q64[:, 1:], t)
    host = dict(pos=s.GetOwnerPosition()[own] + rot,
                r=sph.radius.cpu().numpy().astype(np.float64), own=own,
                vel=s.GetOwnerVelocity().astype(np.float64),
                omg=s.GetOwnerAngVel().astype(np.float64),
                mass=s.GetOwnerMass().astype(np.float64),
                moi=s.GetOwnerMOI().astype(np.float64),
                family=s.GetOwnerFamily())
    p = host["pos"]
    # a box over the lower-left quarter and the lower half, a ball of a
    # quarter of the bed's width around its middle; no sphere centre
    # near a boundary
    lo = p.min(0) - 1.0
    hi = np.asarray([gap_cut(p[:, a], 0.5, window=0.01) for a in range(3)])
    c = 0.5 * (p.min(0) + p.max(0))
    width = p[:, 0].max() - p[:, 0].min()
    d = np.linalg.norm(p - c, axis=1)
    rad = gap_cut(d, float(np.mean(d <= 0.25 * width)), window=0.01)
    box, ball = BoxRegion(lo, hi), SphereRegion(c, rad)
    masks = {"none": np.ones(len(p), bool), "box": box(p), "sphere": ball(p),
             "host": box(p)}
    regions = {"none": None, "box": box, "sphere": ball,
               "host": lambda x: box(x)}
    # the device reduces f32 LBF-relative positions: 16 ulps of the
    # domain's extent
    ext_tol = 16 * float(np.spacing(np.float32(2 * np.abs(s._lbf).max())))
    worst, us = {}, {}
    for kind, region in regions.items():
        times = []
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            for q in QUANTITIES:
                ins = s.CreateInspector(q, region)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = ins.GetValue()
                times.append(time.perf_counter() - t0)
                ref = inspect_ref(s, q, masks[kind], host)
                if q.startswith(("clump_max_", "clump_min_")) and (
                        q != "clump_max_absv"):
                    err, ok = abs(got - ref), abs(got - ref) <= ext_tol
                elif q == "clump_count":
                    err, ok = abs(got - ref), got == ref > 0
                else:
                    err = abs(got - ref) / max(abs(ref), 1e-30)
                    ok = err <= (1e-6 if q == "clump_max_absv" else 1e-5)
                worst[kind, q] = err
                if not ok:
                    fail(f"inspector {q} in region {kind}: {got!r} against "
                         f"the float64 reduction {ref!r}")
        if kind == "host" and bool(warned) != (
                len(p) > DEMInspector.HOST_WARN_SPHERES):
            fail(f"a host-callable region over {len(p)} spheres gave "
                 f"{len(warned)} warnings")
        us[kind] = 1e6 * float(np.median(times))
    ext = max(v for (_, q), v in worst.items() if q in QUANTITIES[:6])
    sums = max(v for (_, q), v in worst.items() if q in QUANTITIES[6:11])
    print(f"[output] inspectors: {len(QUANTITIES)} quantities x 4 regions "
          f"(box {int(masks['box'].sum())}, ball {int(masks['sphere'].sum())} "
          f"of {len(p)} spheres) against float64 numpy: extents within "
          f"{ext:.3g} m (tol {ext_tol:.3g}), speeds and sums within "
          f"{sums:.3g} relative, counts exact; host us per GetValue "
          "(median): " + ", ".join(f"{k} {v:.1f}" for k, v in us.items()),
          flush=True)
    return us


def output_clump_files(s, d):
    """WriteClumpFile in CSV and binary, read back and held to the
    getters to the written precision (exactly: CSV floats are repr)."""
    n = s.GetNumClumps()
    want = {"xyz": s.GetOwnerPosition()[:n],
            "quat": s.GetOwnerOriQ()[:n].astype(np.float64),
            "vel": s.GetOwnerVelocity()[:n].astype(np.float64),
            "ang_vel": s.GetOwnerAngVel()[:n].astype(np.float64)}
    figs = {}
    for fmt in ("csv", "binary"):
        path = os.path.join(d, f"clumps.{fmt}")
        s.SetOutputFormat(fmt)
        t0 = time.perf_counter()
        s.WriteClumpFile(path)
        figs[fmt] = (time.perf_counter() - t0, os.path.getsize(path))
    s.SetOutputFormat("csv")
    t0 = time.perf_counter()
    got = {"xyz": s.ReadClumpXyzFromCsv(os.path.join(d, "clumps.csv")),
           "quat": s.ReadClumpQuatFromCsv(os.path.join(d, "clumps.csv")),
           "vel": s.ReadClumpVelFromCsv(os.path.join(d, "clumps.csv")),
           "ang_vel": s.ReadClumpAngVelFromCsv(os.path.join(d,
                                                            "clumps.csv"))}
    t_read = time.perf_counter() - t0
    for key, by_type in got.items():
        if list(by_type) != ["bed"] or not np.array_equal(by_type["bed"],
                                                          want[key]):
            fail(f"the clump file's {key} read back {list(by_type)} unlike "
                 "the getters")
    z = np.load(os.path.join(d, "clumps.binary"))
    cols = {"xyz": ("x", "y", "z"), "quat": ("Qw", "Qx", "Qy", "Qz"),
            "vel": ("v_x", "v_y", "v_z"), "ang_vel": ("w_x", "w_y", "w_z")}
    for key, names in cols.items():
        if not np.array_equal(np.stack([z[c] for c in names], 1),
                              want[key]):
            fail(f"the binary clump file's {key} differs from the getters")
    if not (z["clump_type"] == "bed").all():
        fail("the binary clump file's clump_type is not the template's name")
    print(f"[output] WriteClumpFile: {n} rows; CSV {figs['csv'][0]:.3f} s, "
          f"{figs['csv'][1]} bytes; binary {figs['binary'][0]:.3f} s, "
          f"{figs['binary'][1]} bytes; the four ReadClump*FromCsv "
          f"{t_read:.3f} s; both equal to GetOwnerPosition/OriQ/Velocity/"
          "AngVel exactly, one type 'bed'", flush=True)


def output_contact_files(torch, s, d):
    """WriteContactFile in CSV and binary, its time split (the force
    pass with extras, the device-side selection with the copies to the
    host, the formatting); its rows against the tables; a force_thres
    run against the rows with |f| > thres."""
    st = s.state
    counts = {1: int(st.ss.count), 2: int(st.st.count), 11: int(st.sa.count)}
    path = os.path.join(d, "contacts.csv")
    s.SetContactOutputFormat("csv")
    reset_counts()
    t0 = time.perf_counter()
    s.WriteContactFile(path)
    t_csv = time.perf_counter() - t0
    launches = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s._fill_contact_fields()
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = s._contact_blocks()
    t_copy = time.perf_counter() - t0
    copied = sum(v.nbytes for b in blocks for k, v in b.items()
                 if isinstance(v, np.ndarray)) + sum(
        v.nbytes for b in blocks for v in b["wildcards"].values())
    del blocks
    s.SetContactOutputFormat("binary")
    t0 = time.perf_counter()
    s.WriteContactFile(os.path.join(d, "contacts.binary"))
    t_bin = time.perf_counter() - t0
    t0 = time.perf_counter()
    idA, idB, ctype = s.ReadContactPairsFromCsv(path)
    t_read = time.perf_counter() - t0
    z = np.load(os.path.join(d, "contacts.binary"))
    per_type = {c: int((ctype == c).sum()) for c in counts}
    n_ss = counts[1]
    if not (len(idA) == s.GetNumContacts() == sum(counts.values())
            and per_type == counts and launches["B-extras"] == 1
            and np.array_equal(idA[:n_ss], st.ss.idA[:n_ss].cpu().numpy())
            and np.array_equal(idB[:n_ss], st.ss.idB[:n_ss].cpu().numpy())
            and np.array_equal(z["A"], idA) and np.array_equal(z["B"], idB)
            and np.array_equal(z["contact_type"], ctype)):
        fail(f"the contact file's rows ({per_type}, {len(idA)} read) differ "
             f"from the tables ({counts}) or the query ran {launches}")
    f = np.stack([z[c] for c in ("f_x", "f_y", "f_z")], 1)
    norm = np.linalg.norm(f, axis=1)
    # the widest gap between the 5 % and 95 % quantiles: |f| on the
    # card and here may part by an ulp
    thres = np.float32(gap_cut(norm, 0.5, window=0.45))
    above = norm[norm > thres].min()
    below = norm[norm <= thres].max()
    if above - below < 16 * np.spacing(thres):
        fail(f"no clear force threshold: |f| {below} and {above} around it")
    t0 = time.perf_counter()
    s.WriteContactFile(os.path.join(d, "kept.binary"), force_thres=thres)
    t_thr = time.perf_counter() - t0
    k = np.load(os.path.join(d, "kept.binary"))
    keep = norm > thres
    if not (0 < keep.sum() < len(keep) and all(
            np.array_equal(k[c], z[c][keep]) for c in z.files)):
        fail(f"force_thres {thres:.6g} kept {len(k['A'])} rows, |f| > thres "
             f"holds for {int(keep.sum())}")
    s.SetContactOutputFormat("csv")
    print(f"[output] WriteContactFile: {len(idA)} rows (SS {counts[1]}, ST "
          f"{counts[2]}, SA {counts[11]}), launches {launches}; CSV "
          f"{t_csv:.3f} s, {os.path.getsize(path)} bytes = force pass with "
          f"extras {t_fill * 1e3:.1f} ms + device selection and copies to "
          f"the host {t_copy * 1e3:.1f} ms ({copied} bytes) + formatting "
          f"{t_csv - t_fill - t_copy:.3f} s; binary {t_bin:.3f} s, "
          f"{os.path.getsize(os.path.join(d, 'contacts.binary'))} bytes; "
          f"ReadContactPairsFromCsv {t_read:.3f} s; force_thres {thres:.6g} "
          f"(binary, {t_thr:.3f} s; |f| {below:.6g} and {above:.6g} on "
          f"its sides) kept {int(keep.sum())} rows, exactly those with "
          "|f| > thres", flush=True)


def phase_output(torch, n_clumps, k, steps):
    """The read side of DEMSolver on the API's mono lattice (a named
    template), after one chunk: inspectors, the clump and contact files
    (in a temporary directory, removed after), ProfileStageTimings with
    the state held bit for bit, then `steps` steps of DoDynamics with
    each K-step window under torch.cuda.set_sync_debug_mode("error") and
    ShowTimingStats' counts."""
    import contextlib
    import io
    import shutil
    import tempfile

    h = API_H
    torch.cuda.empty_cache()
    s = api_solver(n_clumps, k, None, name="bed")
    s.DoDynamics(k * h)
    us = output_inspectors(torch, s)
    d = tempfile.mkdtemp(prefix="chip_smoke_output_")
    try:
        output_clump_files(s, d)
        output_contact_files(torch, s, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # the stage profile leaves the state as it was, bit for bit
    from dem_engine_tpu_torch.state import state_tensors

    before = {p: t.clone() for p, t in state_tensors(s.state)}
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stages = s.ProfileStageTimings(reps=5)
    t_prof = time.perf_counter() - t0
    changed = [p for p, t in state_tensors(s.state)
               if not torch.equal(t, before[p])]
    for line in out.getvalue().splitlines():
        print(f"[output] {line}", flush=True)
    if changed or len(before) < 40 or not all(
            np.isfinite(v) and v >= 0 for v in stages.values()):
        fail(f"ProfileStageTimings changed {changed} or gave {stages}")
    print(f"[output] ProfileStageTimings(reps=5): {t_prof:.3f} s, "
          f"{len(before)} state tensors unchanged bit for bit", flush=True)
    del before
    # DoDynamics with the timers on, each K-step window under sync-debug
    s.ClearTimingStats()
    windows = []
    timed_steps = s.engine.timed_steps

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return timed_steps(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            windows.append(1)

    s.engine.timed_steps = guarded
    t0 = time.perf_counter()
    s.DoDynamics(steps * h)
    dt = time.perf_counter() - t0
    del s.engine.timed_steps
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        s.ShowTimingStats()
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[output] {line}", flush=True)
    n_ref = -(-steps // k)
    if not (len(windows) == n_ref
            and f"over {steps} steps, {n_ref} CD refreshes" in text
            and f"({n_ref} refreshes," in text and f"({steps} steps," in text):
        fail(f"ShowTimingStats does not count {steps} steps and {n_ref} "
             f"refreshes ({len(windows)} windows)")
    print(f"[output] DoDynamics of {steps} steps with the timers on: "
          f"{dt * 1e3 / steps:.3f} ms/step; its {len(windows)} K-step "
          "windows under sync-debug 'error' raised nothing", flush=True)
    physics(torch, s.state, s.engine.cfg.voxel_size, "output")
    del s
    torch.cuda.empty_cache()
    return us


def phase_output_device(torch, n_clumps, k, reps=5):
    """torch.profiler on the output path, after every timed run: the
    device time of a query's force pass with extras (B-extras and its
    sums) on the API's table, and the launches of one step of the
    DoDynamics K-step window with the timers on."""
    from dem_engine_tpu_torch.defines import I

    torch.cuda.empty_cache()
    s = api_solver(n_clumps, k, None, name="bed")
    s.DoDynamics(k * API_H)
    ss, n = s.state.ss, s.state.owners.n
    for attempt in range(3):  # at times a profile records nothing
        rows = device_rows(torch, lambda: [s._fill_contact_fields()
                                           for _ in range(reps)], per=reps)
        b = [r for r in rows if "fused_hertz" in r[2]]
        if b:
            break
        print(f"[output device] profile {attempt + 1} of 3 held no "
              "B-extras event", flush=True)
    else:
        fail("the profiler recorded no B-extras launch")
    bnd = bound(*bytes_B(ss, n, extras=True))
    print(f"[output device] a query's force pass on the API's table "
          f"(cap_ss {ss.cap}): B-extras {b[0][0]:.4f} ms device "
          f"x{b[0][1]:g} a query ({b[0][0] / bnd[0]:.2f}x its bound "
          f"{bnd[0]:.4f} ms); the whole pass "
          f"{sum(r[0] for r in rows):.4f} ms in "
          f"{sum(r[1] for r in rows):g} launches", flush=True)
    ins = s.CreateInspector("clump_kinetic_energy")
    rows = device_rows(torch, lambda: [ins.GetValue() for _ in range(reps)],
                       per=reps)
    print(f"[output device] GetValue (clump_kinetic_energy, no region): "
          f"{sum(r[0] for r in rows):.4f} ms of device time in "
          f"{sum(r[1] for r in rows):g} launches a call; largest: "
          + "; ".join(f"{ms * 1e3:.1f} us x{cnt:g} {name[:40]}"
                      for ms, cnt, name in rows[:4]), flush=True)
    params_k = s.params.replace(max_drift=torch.tensor(
        k, dtype=I, device=DEVICE))
    h = float(s.params.h)
    rows = device_rows(torch, lambda: s.engine.timed_steps(
        s.state, params_k, reps, h, []), per=reps)
    print(f"[output device] DoDynamics' K-step window with the timers on: "
          f"{sum(r[1] for r in rows):g} launches and "
          f"{sum(r[0] for r in rows):.3f} ms of device time per step",
          flush=True)
    del s
    torch.cuda.empty_cache()


# the cohesive bed: the API's mono lattice with the cohesion model of
# cases.cohesion_model at examples/cohesion_pile.py's default Cohesion,
# rolling resistance off (it parts any two implementations on a bed), an
# eighth of the clumps in family 1 whose coh_scale is 0
COHESION = 50.0


def custom_solver(n_clumps, k, device=None):
    """DEMSolver on the API's mono lattice with a custom force model:
    Hertz-Mindlin plus cohesion scaled by the owner wildcard `coh_scale`
    (AddOwnerWildcard 1.0; SetFamilyOwnerWildcardValue 0 on family 1,
    every eighth clump) and the geometry wildcard `stick`
    (AddGeometryWildcard 1.0)."""
    from dem_engine_tpu_torch import DEMSolver
    from dem_engine_tpu_torch.cases import R, bed_geometry, cohesion_model

    geo = bed_geometry(n_clumps)
    dims = geo["dims"]
    s = DEMSolver(device=device or DEVICE)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e9, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.0, "Cohesion": COHESION})
    s.DefineContactForceModel(cohesion_model())
    tmpl = s.LoadClumpType(geo["mass"], geo["moi"], [R] * 3, geo["rel"], mat)
    b = s.AddClumps(tmpl, geo["pos"] - dims / 2)
    b.SetFamilies(np.where(np.arange(b.n) % 8 == 0, 1, 0))
    b.AddOwnerWildcard("coh_scale", 1.0)
    b.AddGeometryWildcard("stick", np.ones(b.n))
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(API_H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    s.Initialize()
    s.SetFamilyOwnerWildcardValue(1, "coh_scale", 0.0)
    return s


def table_pass(s, kind):
    """contact_pass on one of the solver's tables at its current state,
    as a step runs it."""
    from dem_engine_tpu_torch.ops import forces

    st, cfg = s.state, s.engine.cfg
    return forces.contact_pass(kind, getattr(st, kind), st.owners,
                               st.spheres, st.tris, st.anals, s.params,
                               st.time, cfg.voxel_size, cfg.force_model,
                               krec=forces.pack_kinematics(st.owners))


def pass_A(torch, s, tag, kinds=("ss",)):
    """Kernel A on a custom path's contact_pass records (not kernel B's),
    table by table: against the float64 sum and its plain version;
    events, plain, index_add_ and the bound. Returns the first table's
    record."""
    n = s.state.owners.n
    recs = []
    for kind in kinds:
        p = table_pass(s, kind)
        recs.append(hold_A(torch, tag, f"contact_pass {kind.upper()}",
                           p["table"], p["rec_a"], p["rec_b"], n))
    return recs[0]


def hold_A(torch, tag, what, t, rec_a, rec_b, n):
    """Kernel A on the wrench rows (rec_a, rec_b) of table `t`: against
    the float64 sum (1e-5 of the largest) and its plain version; events,
    plain, index_add_ and the bound. Returns the readings."""
    from dem_engine_tpu_torch.ops import segred

    args = (rec_a, t.own_a, rec_b, t.own_b_sorted, t.perm_b)
    sides = ((rec_a, t.own_a, None), (rec_b, t.own_b_sorted, t.perm_b))
    exact = sum(segred.seg_sum_plain(r.double(), i, n, perm=pm)
                for r, i, pm in sides)
    got = segred.seg_sum_pair(*args, n)
    plain = sum(segred.seg_sum_plain(r, i, n, perm=pm)
                for r, i, pm in sides)
    err = float((got.double() - exact).abs().max()) / max(
        float(exact.abs().max()), 1e-30)
    abs_err = float((got - plain).abs().max())
    lib = [index_add_call(torch, r, i, n, pm) for r, i, pm in sides]
    ms = cuda_ms(torch, lambda: segred.seg_sum_pair(*args, n))
    pms = cuda_ms(torch, lambda: [segred.seg_sum_plain(r, i, n, perm=pm)
                                  for r, i, pm in sides])
    lms = cuda_ms(torch, lambda: [c() for c in lib])
    moved = [bytes_A(i, n, pm) for _, i, pm in sides]
    bnd = bound(sum(m[0] for m in moved) + n * 24,
                sum(m[1] for m in moved))
    print(f"[{tag}] A on the {what} table (rows "
          f"{t.cap}, live {int(t.count)}): error against the float64 "
          f"sum {err:.2e} (tol 1e-5), max abs err against the plain "
          f"version {abs_err:.3e}; kernel {ms:.3f} ms by events, plain "
          f"{pms:.3f} ms, index_add_ {lms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    if not err <= 1e-5:
        fail(f"kernel A disagrees with its plain version on the {tag} "
             f"path's {what} table")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=pms, bound=bnd,
                library_ms=lms)


def hertz_cross_check(torch, s):
    """The built-in Hertz model through contact_pass (its fused variant
    dropped by SetPerContactWildcards) against kernel B, on the solver's
    settled SS table (Crr = 0). Per contact (force and torque of both
    sides, relative to the largest): contact_pass within 1e-5 of B's
    plain version (the same f32 operations in torch), and kernel B no
    farther than twice contact_pass's distance from B's plain version
    evaluated in float64 (the overlap, a difference of two numbers ~200
    times larger, leaves any f32 evaluation ~1e-4 of the largest force
    from the exact one, and B's FMAs round apart from torch's). Per owner,
    the wrench within kernel B's tolerance, 2e-4 of the largest; the
    owner sums' distance from the float64 sums is printed beside it."""
    from dem_engine_tpu_torch.models import HertzianForceModel
    from dem_engine_tpu_torch.ops import forces, segred
    from dem_engine_tpu_torch.ops.fused_force import (_wc_names, hertz_rows,
                                                      hertz_rows_cuda)

    st, cfg = s.state, s.engine.cfg
    n, h = st.owners.n, float(s.params.h)
    fused, plain = HertzianForceModel(), HertzianForceModel()
    plain.SetPerContactWildcards(fused.contact_wildcards)
    geo = (st.owners, st.spheres, st.tris, st.anals, s.params)
    t_f = forces.finalize_table("ss", st.ss, *geo, fused)
    t_p = forces.finalize_table("ss", st.ss, *geo, plain)
    krec_w = forces.pack_kinematics(st.owners, True)
    reset_counts()
    b_rows = hertz_rows_cuda(t_f, krec_w, h, cfg.voxel_size, fused)[:2]
    b_runs = read_counts()["B"]
    p = forces.contact_pass("ss", t_p, *geo[:4], s.params, st.time,
                            cfg.voxel_size, plain)
    live = t_p.idA >= 0
    oa, ob = (torch.where(live, o, 0).long() for o in (t_f.own_a,
                                                       t_f.own_b))
    wc = torch.stack([t_f.wildcards[k] for k in _wc_names(t_f, fused)])
    rows = {"kernel": b_rows, "pass": (p["rec_a"], p["rec_b"]),
            "plain": hertz_rows(t_f.fstat_a, wc, krec_w[oa], krec_w[ob],
                                h, cfg.voxel_size, True)[:2],
            "f64": hertz_rows(t_f.fstat_a.double(), wc.double(),
                              krec_w[oa].double(), krec_w[ob].double(), h,
                              cfg.voxel_size, True)[:2]}

    def per_contact(ref, got):
        e = 0.0
        for r, g in zip(rows[ref], rows[got]):
            for part in (slice(0, 3), slice(3, 6)):
                r_, g_ = r[live, part].double(), g[live, part].double()
                e = max(e, float((g_ - r_).abs().max()
                                 / r_.abs().max().clamp_min(1e-30)))
        return e

    def owner_sums(key):
        a, b = rows[key]
        return (segred.seg_sum_plain(a.double(), t_f.own_a, n)
                + segred.seg_sum_plain(b.double(), t_f.own_b_sorted, n,
                                       perm=t_f.perm_b))

    errs = {k: per_contact(*k.split("/")) for k in (
        "plain/pass", "pass/kernel", "f64/kernel", "f64/pass")}
    sums = {k: owner_sums(k) for k in ("kernel", "pass", "f64")}
    own = {f"{ref}/{got} {q}": rel_err(sums[ref][:, part].cpu(),
                                      sums[got][:, part].cpu())
           for ref, got in (("kernel", "pass"), ("f64", "kernel"),
                            ("f64", "pass"))
           for q, part in (("force", slice(0, 3)),
                           ("torque", slice(3, 6)))}
    del rows, sums
    print(f"[custom] built-in Hertz through contact_pass against kernel B "
          f"on the settled table ({int(t_f.count)} live rows, B launched "
          f"{b_runs}): per contact, against B's plain version "
          f"{errs['plain/pass']:.2e} (tol 1e-5); kernel B against it "
          f"{errs['pass/kernel']:.2e}; against the float64 evaluation "
          f"kernel B {errs['f64/kernel']:.2e}, contact_pass "
          f"{errs['f64/pass']:.2e} (kernel B's at most twice "
          f"contact_pass's); per owner "
          + ", ".join(f"{k} {v:.2e}" for k, v in own.items())
          + " (kernel/pass tol 2e-4)", flush=True)
    if not (b_runs == 1 and errs["plain/pass"] <= 1e-5
            and errs["f64/kernel"] <= 2 * errs["f64/pass"]
            and own["kernel/pass force"] <= 2e-4
            and own["kernel/pass torque"] <= 2e-4):
        fail("Hertz through contact_pass disagrees with kernel B")


def phase_custom(torch, n_clumps, k, steps):
    """Configuration (a), the cohesive bed, through DEMSolver: one warm-up
    chunk, then `steps` timed steps of DoDynamics; launch counts (A twice
    a step: SS and SA; no B), memory, physics, friction history live on
    the SS table, the tagged family's coh_scale; then A on the custom SS
    records and the Hertz cross-check. Returns A's record."""
    h = API_H
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s = custom_solver(n_clumps, k)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    s.DoDynamics(k * h)
    attempts0 = s.engine.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s.DoDynamics(steps * h)
    dt = time.perf_counter() - t0
    launches = read_counts()
    refreshes = s.engine.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    st, cfg = s.state, s.engine.cfg
    print(f"[custom] {s.GetNumClumps()} clumps, cohesion model "
          f"({cfg.force_model.name}, fused variant "
          f"{cfg.force_model.fused_variant}), K={k}, {steps} steps after "
          f"a {k}-step warm-up (Initialize {t_init:.2f} s): "
          f"{dt * 1e3 / steps:.3f} ms/step, {n_clumps * steps / dt:.4g} "
          f"clump-steps/s; peak memory {mem / 2**30:.2f} GiB; ss.count "
          f"{int(st.ss.count)} (cap {cfg.cap_ss}) sa.count "
          f"{int(st.sa.count)} (cap {cfg.cap_sa})", flush=True)
    expect = {"A": 2 * steps, "B": 0, "B-extras": 0, "B-ub": 0,
              "C": refreshes, "D": 0, "lists": 0}
    print(f"[custom] launches {launches}, expected {expect} ({refreshes} "
          f"refresh attempts)", flush=True)
    if launches != expect or refreshes < steps // k:
        fail("launch counts do not match the custom path")
    physics(torch, st, cfg.voxel_size, "custom")
    n = int(st.ss.count)
    share = {name: float((st.ss.wildcards[name][:n] != 0).float().mean())
             for name in cfg.force_model.contact_wildcards}
    tagged = s.GetFamilyOwnerWildcardValue(1, "coh_scale")
    rest = s.GetFamilyOwnerWildcardValue(0, "coh_scale")
    print(f"[custom] share of live SS rows with a nonzero wildcard: "
          + ", ".join(f"{kk} {v:.3f}" for kk, v in share.items())
          + f"; family 1: {len(tagged)} clumps with coh_scale "
          f"{sorted(set(tagged.tolist()))}, family 0: {len(rest)} with "
          f"{sorted(set(rest.tolist()))}", flush=True)
    if not (all(v > 0.5 for v in share.values())
            and len(tagged) == n_clumps // 8 and not tagged.any()
            and bool((rest == 1.0).all())):
        fail("the custom path's wildcards are not what it set")
    rec = pass_A(torch, s, "custom")
    rec["launches"] = launches["A"]
    hertz_cross_check(torch, s)
    del s, st
    torch.cuda.empty_cache()
    return rec


# the bonded block: a side^3 lattice of single spheres (side the cube
# root of --clumps: 64 at full size) at pitch 1.98 BOND_R on a floor, built
# as two AddClumps batches (bottom and top halves of the layers)
BOND_R = 0.01
BOND_H = 1e-5


def bond_side(n_clumps):
    return int(round(n_clumps ** (1 / 3)))


def bonded_solver(side, k, existing=None):
    """DEMSolver with the bond model of cases.bond_model on a side^3
    block whose bottom layer rests on the floor; MarkFamilyPersistentContact
    (0) and a dry run bond it, and every row gets `unbroken` 1.0.
    `existing` = (idA, idB, wildcards) seeds the SS table through the
    first batch instead (SetExistingContacts: the first batch's sphere ids
    are global). Returns (solver, bottom batch, top batch, clump centres,
    floor height above the domain's lower corner)."""
    from dem_engine_tpu_torch import DEMSolver
    from dem_engine_tpu_torch.cases import bond_model

    r = BOND_R
    pitch = 1.98 * r
    dims = np.asarray([side * pitch + 20 * r, side * pitch + 20 * r,
                       side * pitch + 40 * r])
    lbf = -dims / 2
    s = DEMSolver(device=DEVICE)
    s.SetVerbosity("WARNING")
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e8, "nu": 0.3, "CoR": 0.3, "mu": 0.4,
                          "Crr": 0.0})
    s.DefineContactForceModel(bond_model())
    tmpl = s.LoadSphereType(2600 * 4 / 3 * np.pi * r**3, r, mat)
    # x fastest, z slowest: the bottom half of the layers comes first
    g = np.mgrid[0:side, 0:side, 0:side].reshape(3, -1).T[:, ::-1]
    # the bottom layer 1 % of a radius into the floor: the SA rows are
    # bonds too
    floor = 2 * r
    pos = lbf + g * pitch + [10 * r, 10 * r, floor + 0.99 * r]
    half = side * side * (side // 2)
    bottom = s.AddClumps(tmpl, pos[:half])
    top = s.AddClumps(tmpl, pos[half:])
    if existing is not None:
        bottom.SetExistingContacts({"idA": existing[0], "idB": existing[1]})
        bottom.SetExistingContactWildcards(existing[2])
    s.AddBCPlane([0, 0, lbf[2] + floor], [0, 0, 1], mat)
    s.MarkFamilyPersistentContact(0)
    s.SetInitTimeStep(BOND_H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(k)
    s.Initialize(dry_run=True)
    if existing is None:
        s.SetContactWildcardValueAll("unbroken", 1.0)
    return s, bottom, top, pos, floor


def cut_block(s, top, pos):
    """The top batch moved up by 4 BOND_R in one SetOwnerPosition: the
    bonds across the cut are no longer detected."""
    s.SetOwnerPosition(np.arange(top.owner_offset, top.owner_offset + top.n),
                       pos[-top.n:] + [0.0, 0.0, 4 * BOND_R])


def ss_keys(torch, t, n_spheres):
    """Sorted int64 keys idA * S + idB of a table's live rows."""
    live = t.idA >= 0
    return torch.sort(t.idA[live].long() * n_spheres
                      + t.idB[live].long()).values


def bonded_restart(torch, s, side, k, d):
    """The restart round trip: the contact file (npz) with `unbroken`,
    read back with np.load, given to a fresh solver by SetExistingContacts
    and SetExistingContactWildcards; its dry run must carry every bond."""
    path = os.path.join(d, "bonds.npz")
    s.SetContactOutputFormat("binary")
    t0 = time.perf_counter()
    s.WriteContactFile(path)
    t_w = time.perf_counter() - t0
    f = np.load(path)
    ss = f["contact_type"] == 1
    pairs = (f["A"][ss], f["B"][ss], {"unbroken": f["unbroken"][ss]})
    S = s.state.spheres.n
    t0 = time.perf_counter()
    fresh = bonded_solver(side, k, existing=pairs)[0]
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    t = fresh.state.ss
    n = int(t.count)
    unb = t.wildcards["unbroken"][:n]
    want = torch.sort(torch.as_tensor(pairs[0], device=DEVICE).long() * S
                      + torch.as_tensor(pairs[1], device=DEVICE).long()
                      ).values
    same = bool(torch.equal(ss_keys(torch, t, S), want))
    carried = int((unb == 1.0).sum())
    print(f"[bonded] restart: contact file {os.path.getsize(path)} bytes "
          f"in {t_w:.2f} s, {int(ss.sum())} SS rows with `unbroken` "
          f"{sorted(set(pairs[2]['unbroken'].tolist()))}; the fresh "
          f"solver's dry run ({t_r:.2f} s): ss.count {n}, the file's pair "
          f"set {same}, rows carrying unbroken 1.0: {carried}",
          flush=True)
    if not (same and carried == n == int(ss.sum())):
        fail("the restart did not carry every bond")
    del fresh


def phase_bonded(torch, side, k, steps):
    """Configuration (b), the bonded block, through DEMSolver: bonds at a
    dry run (SetContactWildcardValueAll("unbroken", 1.0)); the restart
    round trip; the top batch moved up by 4 R in one SetOwnerPosition;
    kernel C's search on the moved block, identical to the plain sweep's,
    finds none of the cross-cut bonds and its list is front-compacted;
    then `steps` steps of DoDynamics in chunks of K: each refresh
    re-injects exactly the cross-cut rows, ss.count unchanged; launch
    counts, memory, physics; and kernel A on the contact_pass records of
    the SS table that holds the re-injected rows and of the SA table."""
    import tempfile

    from dem_engine_tpu_torch.ops import binning, sweep
    from dem_engine_tpu_torch.solver import ss_search_inputs

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s, bottom, top, pos, floor = bonded_solver(side, k)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    st = s.state
    S, nb = st.spheres.n, bottom.n
    n_bonds = int(st.ss.count)
    expect_bonds = 3 * side**2 * (side - 1)
    live = st.ss.idA >= 0
    cross = live & ((st.ss.idA < nb) != (st.ss.idB < nb))
    n_cross = int(cross.sum())
    cut_keys = torch.sort(st.ss.idA[cross].long() * S
                          + st.ss.idB[cross].long()).values
    print(f"[bonded] {S} spheres in two batches ({nb} + {top.n}), "
          f"Initialize with its dry run {t_init:.2f} s: {n_bonds} SS "
          f"bonds (3*{side}^2*{side - 1} = {expect_bonds}), "
          f"{int(st.sa.count)} on the floor, {n_cross} across the cut",
          flush=True)
    if not (n_bonds == expect_bonds and n_cross == side**2
            and int(st.sa.count) == side**2):
        fail("the bonded block does not hold its lattice's bonds")
    with tempfile.TemporaryDirectory() as d:
        bonded_restart(torch, s, side, k, d)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cut_block(s, top, pos)
    torch.cuda.synchronize()
    t_set = time.perf_counter() - t0
    cfg = s.engine.cfg
    params_k = s.params.replace(max_drift=torch.tensor(
        k, dtype=torch.int32, device=DEVICE))
    q = ss_search_inputs(s.state, params_k, cfg.voxel_size)
    fa, fb, n_det, tab = sweep.find_pairs_ss(
        q["pos_cd"], q["reach"], q["owner"], q["family"], q["family_mask"],
        q["bin_size"], q["nb_cd"], cfg.cap_ss)
    pa, pb, pn = binning.sweep_table(tab, S, q["family_mask"], q["nb_cd"],
                                     cfg.cap_ss, int(tab.max_occ))
    same = (int(pn) == int(n_det) and torch.equal(fa, pa)
            and torch.equal(fb, pb))
    n_det = int(n_det)
    compact = bool((fa[:n_det] >= 0).all() and (fa[n_det:] == -1).all())
    found = fa[:n_det].long() * S + fb[:n_det].long()
    redetected = int(torch.isin(found, cut_keys).sum())
    print(f"[bonded] SetOwnerPosition of {top.n} owners {t_set * 1e3:.1f} "
          f"ms; kernel C on the moved block: {n_det} pairs (bonds less "
          f"the cut: {n_bonds - n_cross}), identical to the plain sweep's "
          f"table and count {same} (plain {int(pn)}), {redetected} of the "
          f"cut bonds found, list front-compacted {compact}", flush=True)
    if not same:
        fail("kernel C's pair table on the cut block differs from the "
             "plain sweep")
    if not (n_det == n_bonds - n_cross and redetected == 0 and compact):
        fail("the cut block's pair search is not what the cut implies")
    del q, fa, fb, pa, pb, tab, found

    chunks = steps // k
    attempts0 = s.engine.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dt, counts, reinjected = 0.0, [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        s.DoDynamics(k * BOND_H)  # synchronises before it returns
        dt += time.perf_counter() - t0
        t = s.state.ss
        counts.append(int(t.count))
        keys = t.idA.long() * S + t.idB.long()
        reinjected.append(int(((t.idA >= 0) & torch.isin(keys, cut_keys)
                               ).sum()))
    launches = read_counts()
    refreshes = s.engine.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    st = s.state
    n = int(st.ss.count)
    unb = st.ss.wildcards["unbroken"][:n]
    keys = st.ss.idA[:n].long() * S + st.ss.idB[:n].long()
    cut_rows = torch.isin(keys, cut_keys)
    persist_all = bool((st.ss.persist[:n] == 1).all())
    print(f"[bonded] {steps} steps at K={k} in {chunks} DoDynamics chunks: "
          f"{dt * 1e3 / (chunks * k):.3f} ms/step; peak memory "
          f"{mem / 2**30:.2f} GiB; ss.count per refresh {counts} (before "
          f"the cut {n_bonds}); re-injected (cross-cut) rows per refresh "
          f"{reinjected}; bonds intact {int((unb > 0.5).sum())} of {n}, "
          f"cut rows broken {int((unb[cut_rows] == 0).sum())} of "
          f"{int(cut_rows.sum())}; every row persistent {persist_all}",
          flush=True)
    expect = {"A": 2 * chunks * k, "B": 0, "B-extras": 0, "B-ub": 0,
              "C": refreshes, "D": 0, "lists": 0}
    print(f"[bonded] launches {launches}, expected {expect} ({refreshes} "
          f"refresh attempts)", flush=True)
    if launches != expect or refreshes < chunks:
        fail("launch counts do not match the bonded path")
    if not (all(c == n_bonds for c in counts)
            and all(r == n_cross for r in reinjected) and persist_all
            and int((unb[cut_rows] == 0).sum()) == n_cross):
        fail("the bonded block's re-injection is not exact")
    physics(torch, st, cfg.voxel_size, "bonded", floor=floor)
    print(f"[bonded] kernel A on the last step's tables, the SS table "
          f"holding {int(cut_rows.sum())} re-injected rows:", flush=True)
    pass_A(torch, s, "bonded", ("ss", "sa"))
    del s, st
    torch.cuda.empty_cache()


def custom_device(torch, s, reps=10):
    """Kernel A's device time on the custom path's SS records of solver
    `s` (torch.profiler; one pair call: a zeroing and one launch)."""
    from dem_engine_tpu_torch.ops import segred

    p = table_pass(s, "ss")
    t, n = p["table"], s.state.owners.n
    rows, totals = profiled_calls(
        torch, lambda: segred.seg_sum_pair(p["rec_a"], t.own_a, p["rec_b"],
                                           t.own_b_sorted, t.perm_b, n),
        reps, 2, "A on the custom path's SS table")
    dev = sum(r[0] for r in rows)
    print(f"[custom device] A on the contact_pass SS table: {dev:.4f} ms "
          f"in {sum(r[1] for r in rows):g} launches", flush=True)
    return dev


# phase 14, the rest of the API: the tuners' bound on K, the insertion's
# layers and its downward speed
REST_MAX_K = 52
REST_LAYERS = 4
REST_V = 1.0


def c_against_plain(torch, s, bin_factor=None):
    """Kernel C on the search inputs of solver `s`'s next refresh (at
    `bin_factor`, else the engine's), against the plain sweep on the same
    sorted table: (identical pair table and count, pairs, max bin
    occupancy, the table and its search arguments)."""
    from dem_engine_tpu_torch.ops import binning, sweep
    from dem_engine_tpu_torch.solver import ss_search_inputs

    bf = s.engine.bin_factor if bin_factor is None else bin_factor
    st = s.state
    params = s.params.replace(
        max_drift=torch.tensor(s.GetUpdateFreq(), dtype=torch.int32,
                               device=DEVICE),
        bin_factor=torch.tensor(bf, dtype=torch.float32, device=DEVICE))
    q = ss_search_inputs(st, params, s._voxel_size)
    S = st.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     S)
    cap = s.engine.cfg.cap_ss
    args = (tab, S, q["family_mask"], q["nb_cd"], cap)
    ka, kb, kn = sweep.sweep_table_cuda(*args)
    mpb = int(tab.max_occ)
    pa, pb, pn = binning.sweep_table(*args, mpb)
    same = (int(kn) == int(pn) and torch.equal(ka, pa)
            and torch.equal(kb, pb))
    return same, int(kn), mpb, args


def max_speed(s):
    """The largest owner speed of solver `s`, m/s."""
    return float(np.linalg.norm(s.GetOwnerVelocity(), axis=1).max())


def owner_z(torch, s, ids, top=False):
    """Lowest sphere bottom (LBF-relative z) of the owners `ids`; with
    `top`, their highest sphere top."""
    from dem_engine_tpu_torch.solver import sphere_world_pos

    st = s.state
    pos = sphere_world_pos(st.owners, st.spheres, s._voxel_size)
    sel = torch.isin(st.spheres.owner.long(),
                     torch.as_tensor(ids, device=DEVICE))
    if top:
        return float((pos[sel, 2] + st.spheres.radius[sel]).max())
    return float((pos[sel, 2] - st.spheres.radius[sel]).min())


def phase_rest(torch, n_clumps, k, tune_steps=3200, steps=250,
               insert_steps=1000, resize_steps=50):
    """Phase 14: the rest of the API on one DEMSolver of the API's mono
    lattice (unique fetch off): (a) the tuners, (b) a checkpoint, (c)
    UpdateClumps, (d) PurgeFamily, (e) ChangeClumpSizes. Returns the
    solver and kernel C's search arguments at the largest bin factor the
    tuner visited and at 1.0, for the profiled part of the run."""
    import shutil
    import tempfile

    from dem_engine_tpu_torch import Engine
    from dem_engine_tpu_torch.cases import R, bed_geometry
    from dem_engine_tpu_torch.ops import binning, sweep
    from dem_engine_tpu_torch.state import state_tensors

    h = API_H
    torch.cuda.empty_cache()
    s = api_solver(n_clumps, k, 0)
    eng = s.engine
    events = []
    sink = eng.log

    def capture(level, msg):
        events.append((level, msg))
        sink(level, msg)

    eng.log = capture
    vs = s._voxel_size

    # (a) the tuners -----------------------------------------------------
    s.UseAdaptiveUpdateFreq()
    s.UseAdaptiveBinSize()
    s.SetCDMaxUpdateFreq(REST_MAX_K)
    lost0 = int(s.state.lost_contacts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.DoDynamics(tune_steps * h)
    dt = time.perf_counter() - t0
    blocks = eng.blocks
    for i, b in enumerate(blocks):
        print(f"[rest] tuners: block {i + 1} K={b['k']} bin factor "
              f"{b['bin_factor']:g}: {b['per'] * 1e3:.3f} ms/step by "
              f"events; ss.count {b['ss_count']}/{b['cap_ss']}, grows "
              f"{b['grows']}{'' if b['counted'] else ' (not counted)'}"
              f"{', re-tuned' if b['retuned'] else ''}; next K="
              f"{b['k_next']} bin factor {b['bin_next']:g}", flush=True)
    ks = ({b["k"] for b in blocks}
          | {b["k_next"] for b in blocks if b["k_next"]})
    bfs = ({b["bin_factor"] for b in blocks}
           | {b["bin_next"] for b in blocks})
    lost = int(s.state.lost_contacts) - lost0
    moves = [m for lvl, m in events if m.startswith("adaptive")]
    print(f"[rest] tuners: {tune_steps} steps in {dt:.2f} s "
          f"({dt * 1e3 / tune_steps:.3f} ms/step), {len(blocks)} blocks, "
          f"K visited {sorted(ks)}, bin factors {sorted(bfs)}, "
          f"{len(moves)} moves logged, GetUpdateFreq {s.GetUpdateFreq()}, "
          f"contacts lost {lost}, max |v| {max_speed(s):.4f} m/s", flush=True)
    if len(ks) < 2 or len(bfs) < 2:
        fail(f"a tuner never moved: K {sorted(ks)}, bin {sorted(bfs)}")
    if not (ks <= set(Engine.K_LADDER) and max(ks) <= REST_MAX_K
            and bfs <= set(Engine.BIN_LADDER)):
        fail(f"a tuner left its ladder: K {sorted(ks)}, bin {sorted(bfs)}")
    if lost:
        fail(f"{lost} contacts lost their history under the tuners")
    physics(torch, s.state, vs, "rest tuners")
    bf_max = max(bfs)
    if bf_max == 1.0:
        s.SetBinSize(2.2 * s._bin_floor())
        bf_max = s.engine.bin_factor
    c_tabs = {}
    for bf in (bf_max, 1.0):
        saved = read_counts()
        same, n_pairs, mpb, args = c_against_plain(torch, s, bf)
        c_tabs[bf] = args
        ms = cuda_ms(torch, lambda: sweep.sweep_table_cuda(*args))
        pms = cuda_ms(torch, lambda: binning.sweep_table(*args, mpb),
                      reps=5, warm=1)
        set_counts(saved)
        print(f"[rest] C at bin factor {bf:g}: {n_pairs} pairs, max bin "
              f"occupancy {mpb}, identical to the plain sweep {same}; "
              f"kernel {ms:.4f} ms by events, plain {pms:.3f} ms",
              flush=True)
        if not same:
            fail(f"kernel C differs from the plain sweep at bin factor {bf}")

    # (b) the checkpoint, tuners off --------------------------------------
    s.DisableAdaptiveUpdateFreq()
    s.UseAdaptiveBinSize(False)
    d = tempfile.mkdtemp(prefix="rest_ckpt_")
    try:
        path = os.path.join(d, "state.npz")
        saved = {p: t.clone() for p, t in state_tensors(s.state)}
        t0 = time.perf_counter()
        s.SaveCheckpoint(path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        s.DoDynamics(steps * h)
        p1 = s.GetOwnerPosition()
        t0 = time.perf_counter()
        s.LoadCheckpoint(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        back = [p for p, t in state_tensors(s.state)
                if not torch.equal(t, saved[p])]
        s.DoDynamics(steps * h)
        p2 = s.GetOwnerPosition()
        err = float(np.abs(p1 - p2).max()) / R
        fresh = api_solver(n_clumps, k, 0)
        fresh.LoadCheckpoint(path)
        fresh_diff = [p for p, t in state_tensors(fresh.state)
                      if not torch.equal(t, saved[p])]
        fresh.DoDynamics(k * h)
        fresh_ok = bool(np.isfinite(fresh.GetOwnerVelocity()).all())
        del fresh
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"[rest] checkpoint: {len(saved)} tensors, {size} bytes (cap_ss "
          f"{eng.cfg.cap_ss}, cap_sa {eng.cfg.cap_sa}), saved in "
          f"{t_save:.2f} s, loaded in {t_load:.2f} s; after the load "
          f"{len(back)} tensors differ from the saved; the {steps}-step "
          f"replay: max |P1 - P2| = {err:.3e} R, identical "
          f"{bool(np.array_equal(p1, p2))}; a fresh solver: {len(fresh_diff)}"
          f" tensors differ, its chunk finite {fresh_ok}", flush=True)
    del saved
    if back or fresh_diff or err > 1e-3 or not fresh_ok:
        fail("the checkpoint did not restore the run")

    # (c) UpdateClumps: layers on the bed's pitch, 0.5 R above the live
    # bed's highest sphere (the lattice starts 0.01 R overlapped and
    # dilates, so its top has risen since Initialize) ---------------------
    geo = bed_geometry(n_clumps)
    dims = geo["dims"]
    pos = geo["pos"]
    layer = pos[pos[:, 2] == pos[:, 2].max()]
    all_ids = np.arange(s.GetNumOwners())
    top = owner_z(torch, s, all_ids, top=True)
    dz = 3.99 * R
    # a clump's lowest sphere bottom lies 2 R below its centre
    new = np.concatenate([layer * [1.0, 1.0, 0.0]
                          + [0.0, 0.0, top + 2.5 * R + j * dz]
                          for j in range(REST_LAYERS)]) - dims / 2
    n0, s0, c0 = s.GetNumOwners(), s.GetNumSpheres(), s.GetNumClumps()
    b = s.AddClumps(s._templates[0], new)
    b.SetFamilies(2)
    b.SetVel([0.0, 0.0, -REST_V])
    # the bed's cap_ss holds 1.25x its count after maybe_shrink, more than
    # the layers add: cut it to the live count (512-aligned), so that the
    # insertion's contacts must grow the table through grow_for
    cnt = int(s.state.ss.count)
    cap = -(-cnt // 512) * 512
    eng.cfg = dataclasses.replace(eng.cfg, cap_ss=cap)
    s.state = s.state.replace(ss=s.state.ss.shrunk(cap))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.UpdateClumps()
    torch.cuda.synchronize()
    t_upd = time.perf_counter() - t0
    new_ids = np.arange(n0, n0 + len(new))
    z0 = owner_z(torch, s, new_ids)
    counts = (s.GetNumOwners() - n0, s.GetNumSpheres() - s0,
              s.GetNumClumps() - c0)
    events.clear()
    grows0, attempts0 = eng.timers["grows"], eng.refresh_attempts
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s.DoDynamics(insert_steps * h)
    dt = time.perf_counter() - t0
    launches = read_counts()
    refreshes = eng.refresh_attempts - attempts0
    mem = torch.cuda.max_memory_allocated()
    grows = eng.timers["grows"] - grows0
    logged = [m for lvl, m in events if lvl == "STEP_METRIC"
              and m.startswith("capacity/strategy growth")]
    z1 = owner_z(torch, s, new_ids)
    same, n_pairs, mpb, _ = c_against_plain(torch, s)
    expect = {"A": 2 * insert_steps, "B": insert_steps, "B-extras": 0,
              "B-ub": 0, "C": refreshes, "D": 0, "lists": 0}
    print(f"[rest] UpdateClumps: {len(new)} clumps in {REST_LAYERS} layers "
          f"at {REST_V} m/s down from {top / R + 0.5:.3f} R (the bed's "
          f"highest sphere top {top / R:.3f} R, its lattice's "
          f"{(pos[:, 2].max() + 2 * R) / R:.3f} R), {t_upd * 1e3:.1f} ms; "
          f"owners +{counts[0]}"
          f", spheres +{counts[1]}, clumps +{counts[2]}; cap_ss cut to "
          f"{cap} for the count {cnt}; {insert_steps} steps in {dt:.2f} s "
          f"({dt * 1e3 / insert_steps:.3f} ms/step), growths {grows} "
          f"(logged at STEP_METRIC {len(logged)}: {logged[:2]}), cap_ss "
          f"{eng.cfg.cap_ss}, ss.count {int(s.state.ss.count)}; peak memory "
          f"{mem / 2**30:.2f} GiB; the layer's lowest z {z0 / R:.3f} R -> "
          f"{z1 / R:.3f} R; C on the grown table: {n_pairs} pairs, "
          f"identical {same}; max |v| {max_speed(s):.4f} m/s", flush=True)
    print(f"[rest] launches {launches}, expected {expect} ({refreshes} "
          f"refresh attempts)", flush=True)
    if counts != (len(new), 3 * len(new), len(new)):
        fail(f"UpdateClumps added {counts}")
    if not (grows >= 1 and len(logged) == grows):
        fail("the insertion did not grow the SS table, or its growths "
             "were not logged at STEP_METRIC")
    if launches != expect or not same or not z1 < z0:
        fail("the run after UpdateClumps")
    physics(torch, s.state, vs, "rest insert")

    # (d) PurgeFamily(2), with the JAX package's rule evaluated here ------
    fam = s.GetOwnerFamily()
    nc = s.GetNumClumps()
    keep = ~((fam == 2) & (np.arange(len(fam)) < nc))
    o = s.state.owners
    vox, loc = o.vox.clone(), o.loc.clone()
    keep_t = torch.as_tensor(keep, device=DEVICE)
    t0 = time.perf_counter()
    s.PurgeFamily(2)
    torch.cuda.synchronize()
    t_purge = time.perf_counter() - t0
    st = s.state
    n_left = s.GetNumOwners()
    bit = (torch.equal(st.owners.vox, vox[keep_t])
           and torch.equal(st.owners.loc, loc[keep_t]))
    sph_ok = (int(st.spheres.owner.max()) < n_left
              and st.spheres.n == 3 * s.GetNumClumps())
    del vox, loc
    s.DoDynamics(k * h)
    same, n_pairs, _, _ = c_against_plain(torch, s)
    print(f"[rest] PurgeFamily(2): {t_purge * 1e3:.1f} ms; the rule keeps "
          f"{int(keep.sum())} owners (family 2 below GetNumClumps() {nc} "
          f"purged; {int(((fam == 2) & keep).sum())} inserted clump(s) at "
          f"or past it kept), the solver has {n_left}, clumps "
          f"{s.GetNumClumps()}, spheres {st.spheres.n}; no sphere names a "
          f"purged owner {sph_ok}; kept owners' positions bit for bit "
          f"{bit}; after one chunk C: {n_pairs} pairs, identical {same}; "
          f"max |v| {max_speed(s):.4f} m/s", flush=True)
    if not (n_left == int(keep.sum()) and sph_ok and bit and same):
        fail("PurgeFamily")

    # (e) ChangeClumpSizes of every tenth clump ---------------------------
    ids = np.arange(0, s.GetNumClumps(), 10)
    sph = s.state.spheres
    r0, rel0 = sph.radius.clone(), sph.relpos.clone()
    s.ChangeClumpSizes(ids, 0.95)
    fac = torch.ones(s.GetNumOwners(), device=DEVICE)
    fac[torch.as_tensor(ids, device=DEVICE)] = 0.95
    per = fac[sph.owner.long()]
    sph = s.state.spheres
    exact = (torch.equal(sph.radius, r0 * per)
             and torch.equal(sph.relpos, rel0 * per[:, None]))
    s.DoDynamics(resize_steps * h)
    vmax = max_speed(s)
    v_bound = REST_V + float(np.sqrt(2 * 9.81 * dims[2]))
    same, n_pairs, _, _ = c_against_plain(torch, s)
    print(f"[rest] ChangeClumpSizes: {len(ids)} clumps by 0.95, radii and "
          f"offsets scaled exactly {exact}; {resize_steps} steps: max |v| "
          f"{vmax:.4f} m/s (bound {v_bound:.3f}: the insertion speed plus "
          f"a fall through the domain), C: {n_pairs} pairs, identical "
          f"{same}", flush=True)
    if not (exact and vmax < v_bound and same):
        fail("ChangeClumpSizes")
    physics(torch, s.state, vs, "rest resize")
    dyn = s.GetDeviceMemUsageDynamic()
    kin = s.GetDeviceMemUsageKinematic()
    print(f"[rest] memory getters: state {dyn / 2**20:.1f} MiB, a refresh "
          f"beyond it {kin / 2**20:.1f} MiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    eng.log = sink
    return s, c_tabs


def rest_device(torch, c_tabs, reps=10):
    """Kernel C's device time (torch.profiler) on the tuned bed's table at
    the largest bin factor visited and at 1.0; each search one memset and
    one launch. Returns {bin factor: (device ms, launches, bound)}."""
    from dem_engine_tpu_torch.ops import sweep

    out = {}
    for bf, args in c_tabs.items():
        n = int(sweep.sweep_table_cuda(*args)[2])
        bnd = bound(*bytes_C(args[0], args[4], n))
        rows, _ = profiled_calls(torch, lambda: sweep.sweep_table_cuda(*args),
                                 reps, 2, f"C at bin factor {bf:g}")
        dev = sum(r[0] for r in rows)
        cnt = sum(r[1] for r in rows)
        print(f"[rest device] C at bin factor {bf:g}: {dev:.4f} ms in {cnt} "
              f"launches, {n} pairs; bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{dev / bnd[0]:.2f}x", flush=True)
        out[bf] = (dev, cnt, bnd)
    return out


DEMO_CHUNKS = 4
TWIN_TOL = 1e-5  # a twin's card output against its CPU output, of the largest


def phase_demos(torch, tmp, chunks=DEMO_CHUNKS):
    """Phase 15: every example through load_example on the card, at the
    size its JAX test builds (tests/torch_scenes.py), Initialize and
    `chunks` CD chunks: finite state, no contact lost, the example's own
    invariant, the path's kernels launched (C every refresh, A each step,
    and B each step where the model has a fused variant); for the 8 torch
    twins, their force model or callables on the card against the same on
    the CPU.
    Returns the scenes with their timings, for the launch counts that the
    profile takes at the end of the run."""
    from dem_engine_tpu_torch.examples import NAMES, TWINS
    from dem_engine_tpu_torch.ops import forces
    from torch_scenes import chunk_time, scene, twin_outputs

    t_phase = time.perf_counter()
    done = []
    totals = dict.fromkeys(KERNELS, 0)
    for name in NAMES:
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        sc = scene(name, DEVICE, d)
        s = sc.solver
        t_init = time.perf_counter() - t0
        k = s.GetUpdateFreq()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(chunks):
            s.DoDynamics(chunk_time(s))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        for key, v in counts.items():
            totals[key] += v
        steps = chunks * k
        st = s.state
        fused = (st.spheres.n > 0 and st.ss.cap > 0
                 and forces.fused_ss(s.engine.cfg.force_model))
        finite = all(bool(torch.isfinite(x).all()) for x in (
            st.owners.vel, st.owners.omg, st.owners.loc, st.owners.quat))
        line = (f"{s.GetNumClumps()} clumps, {st.spheres.n} spheres, "
                f"{st.tris.n} triangles, K={k}: init {t_init:.2f} s, "
                f"{dt * 1e3 / steps:.3f} ms/step over {steps} steps, "
                f"{s.GetNumContacts()} contacts, lost "
                f"{int(st.lost_contacts)}; kernels "
                + ", ".join(f"{key} {v}" for key, v in counts.items() if v))
        print(f"[demos] {name}: {line}", flush=True)
        if not finite or int(st.lost_contacts):
            fail(f"demos: {name}: state not finite or a contact lost")
        try:
            sc.check()
        except AssertionError as e:
            fail(f"demos: {name}: its invariant failed: {e}")
        if (counts["C"] < chunks or (fused and counts["B"] != steps)
                or (not fused and counts["B"]) or counts["A"] < steps):
            fail(f"demos: {name}: launches {counts} off its path (C at "
                 f"least {chunks}, B {steps if fused else 0}, A at least "
                 f"{steps})")
        if name in TWINS:
            card = twin_outputs(name, DEVICE)
            host = twin_outputs(name, "cpu")
            errs = {}
            for key, ref in host.items():
                got = card[key]
                errs[key] = (float(np.abs(got != ref).sum())
                             if ref.dtype == bool else rel_err(ref, got))
            worst = max(errs.values())
            print(f"[demos] {name}: twin on the card against the CPU, "
                  f"{len(errs)} outputs, largest error {worst:.3g} "
                  f"(limit {TWIN_TOL:g} of the largest value; rule "
                  f"outputs exactly)", flush=True)
            if any(v > (0 if host[key].dtype == bool else TWIN_TOL)
                   for key, v in errs.items()):
                fail(f"demos: {name}: twin output off its CPU evaluation: "
                     f"{errs}")
        done.append((sc, k, dt * 1e3 / steps))
    print(f"[demos] {len(done)} examples, kernels over the phase {totals}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not all(totals[key] for key in ("A", "B", "C")):
        fail(f"demos: a kernel of the path never launched: {totals}")
    return done


def demos_device(torch, done):
    """Launches a step of each example (torch.profiler, one chunk)."""
    from torch_scenes import chunk_time

    for sc, k, ms in done:
        s = sc.solver
        rows = device_rows(torch, lambda: s.DoDynamics(chunk_time(s)))
        busy = sum(r[0] for r in rows) / k
        print(f"[demos device] {sc.name}: {sum(r[1] for r in rows) / k:.1f} "
              f"launches and {busy:.3f} ms of device time a step "
              f"(refresh included), {ms:.3f} ms/step timed", flush=True)


# the goldens the default run holds (the five of
# tests/test_engine_two_spheres.py, slide-to-roll and the settling bed,
# whose final tables the kernels are held on); the other three run under
# --phases goldens-long and in tests/test_torch_goldens.py
GOLDENS_DEFAULT = ("head_on_restitution", "head_on_frictionless_model",
                   "no_contact_no_motion", "plane_bounce_restitution",
                   "head_on_restitution_segment_reduce", "slide_to_roll",
                   "settling_bed")


def phase_goldens(torch, names, kernels):
    """Phase 18: the engine goldens of the JAX package's tests
    (tests/torch_behaviour.py's GOLDENS, those in `names`) through
    Engine.advance on the card at their own lengths: each reading beside
    the JAX bound, steps, ms/step and the launches of A, B and C, which
    must be on the path (B every step, A at least every step, C at least
    every refresh); with `kernels`, then C, B and A at the goldens'
    shapes (``goldens_kernels``). Fails on any miss, after running every
    golden."""
    import torch_behaviour as tb

    t_phase = time.perf_counter()
    missed = []
    runs = {}
    for g in tb.GOLDENS:
        if g.name not in names:
            continue
        reset_counts()
        r = runs[g.name] = g.run(DEVICE)
        counts = read_counts()
        steps = r["steps"]
        try:
            g.check(r)
            verdict = "held"
        except AssertionError as e:
            why = str(e).strip().splitlines() or ["assertion failed"]
            verdict = f"MISSED ({why[-1]})"
        print(f"[goldens] {g.name} ({g.jax_test}): {g.reading(r)}; bound "
              f"{g.bound}: {verdict}; {steps} steps, "
              f"{r['seconds'] * 1e3 / steps:.3f} ms/step, launches A "
              f"{counts['A']} B {counts['B']} C {counts['C']}", flush=True)
        if verdict != "held":
            missed.append(g.name)
        k = r["k"]
        if (counts["B"] != steps or counts["A"] < steps
                or counts["C"] < -(-steps // k)):
            fail(f"goldens: {g.name}: launches {counts} off its path (B "
                 f"{steps}, A at least {steps}, C at least "
                 f"{-(-steps // k)})")
    if kernels:
        goldens_kernels(torch, runs)
    print(f"[goldens] phase 18: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if missed:
        fail(f"goldens: missed their JAX bounds: {missed}")


def c_tiny(torch, eng, state, params, k, what):
    """Kernel C on the search inputs of the next refresh of a golden's
    state, against the plain sweep: pair table and count at the engine's
    cap_ss and at a cap below the pair count. Returns the pair count."""
    from dem_engine_tpu_torch.ops import binning, sweep
    from dem_engine_tpu_torch.solver import ss_search_inputs

    q = ss_search_inputs(state, params.replace(max_drift=torch.tensor(
        k, dtype=torch.int32, device=DEVICE)), eng.cfg.voxel_size)
    S = state.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     max(S, 1))
    mpb = int(tab.max_occ)
    cap = eng.cfg.cap_ss
    args = (tab, S, q["family_mask"], q["nb_cd"])
    pairs = int(binning.sweep_table(*args, cap, mpb)[2])
    same = {}
    for c in (cap, max(pairs - 1, 0)):
        ka, kb, kn = sweep.sweep_table_cuda(*args, c)
        qa, qb, qn = binning.sweep_table(*args, c, mpb)
        same[c] = (int(kn) == int(qn) == pairs and torch.equal(ka, qa)
                   and torch.equal(kb, qb))
    ms = cuda_ms(torch, lambda: sweep.sweep_table_cuda(*args, cap))
    pms = cuda_ms(torch, lambda: binning.sweep_table(*args, cap, mpb))
    bnd = bound(*bytes_C(tab, cap, pairs))
    print(f"[goldens] C on the {what} table ({S} spheres, {tab.n_rows} "
          f"rows, cap_ss {cap}): {pairs} pairs, "
          f"identical to the plain sweep (pair table and count) at cap "
          f"{cap}: {same[cap]}, at cap {max(pairs - 1, 0)} (count past "
          f"it): {same[max(pairs - 1, 0)]}; kernel {ms:.3f} ms plain "
          f"{pms:.3f} ms bound {bnd[0]:.3g} ms ({bnd[1]})", flush=True)
    if not all(same.values()) or pairs == 0:
        fail(f"goldens: kernel C differs from the plain sweep on the "
             f"{what} table, or found no pair")
    return pairs


def a_tiny(torch, what, t, rec_a, rec_b, n):
    """Kernel A on a golden's table (hold_A: against the float64 sum and
    its plain version), and exactly zero for every owner with no live
    row in it."""
    from dem_engine_tpu_torch.ops import segred

    hold_A(torch, "goldens", what, t, rec_a, rec_b, n)
    got = segred.seg_sum_pair(rec_a, t.own_a, rec_b, t.own_b_sorted,
                              t.perm_b, n)
    has = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    for ids in (t.own_a, t.own_b_sorted):
        live = (ids >= 0) & (ids < n)
        has[ids[live].long()] = True
    stray = int((got[~has] != 0).sum())
    print(f"[goldens] A on the {what} table: {int((~has).sum())} of {n} "
          f"owners have no live row, {stray} nonzero entries among their "
          f"sums (must be 0)", flush=True)
    if stray:
        fail(f"goldens: kernel A wrote to owners with no live row of the "
             f"{what} table")


def goldens_kernels(torch, runs):
    """Kernels C, B and A at the goldens' shapes, their launches here not
    counted: the two-sphere table (cap_ss 16) 100 steps after the contact
    forms and with no contact; the settling bed's tables after its 12,000
    steps (its golden's end state in `runs`, else run again); the mesh
    bounce's ST rows in contact."""
    from dem_engine_tpu_torch.ops import forces
    from dem_engine_tpu_torch.ops.fused_force import hertz_rows_cuda
    import torch_behaviour as tb

    saved = read_counts()

    def ss_rows(eng, state, params):
        return hertz_rows_cuda(
            state.ss, forces.pack_kinematics(state.owners, world_omg=True),
            float(params.h), eng.cfg.voxel_size, eng.cfg.force_model)[:2]

    def passed(eng, state, params, kind):
        p = forces.contact_pass(
            kind, getattr(state, kind), state.owners, state.spheres,
            state.tris, state.anals, params, state.time, eng.cfg.voxel_size,
            eng.cfg.force_model, krec=forces.pack_kinematics(state.owners))
        return p["table"], p["rec_a"], p["rec_b"]

    for v0, steps, what in ((1.0, 2600, "two-sphere (in contact)"),
                            (0.0, 100, "two-sphere (no contact)")):
        eng, state, params, _ = tb.two_sphere_setup(DEVICE, v0=v0, cor=0.8)
        state = eng.advance(state, params, steps, update_freq=50)
        if v0:
            c_tiny(torch, eng, state, params, 50, what)
            hold_B(torch, "goldens", what, state, eng.cfg, float(params.h))
        a_tiny(torch, f"{what} SS", state.ss, *ss_rows(eng, state, params),
               state.owners.n)

    bed = runs.get("settling_bed") or tb.settling_bed(DEVICE)
    eng, state, params = bed["final"]
    c_tiny(torch, eng, state, params, 20, "settling bed's")
    hold_B(torch, "goldens", "settling bed's", state, eng.cfg,
           float(params.h))
    a_tiny(torch, "settling bed's SS", state.ss,
           *ss_rows(eng, state, params), state.owners.n)
    a_tiny(torch, "settling bed's SA", *passed(eng, state, params, "sa"),
           state.owners.n)

    eng, state, params, _ = tb.mesh_bounce_setup(DEVICE, at_impact=True)
    state = eng.advance(state, params, 300, update_freq=30)
    st, ra, rb = passed(eng, state, params, "st")
    if int(st.count) == 0 or not bool((ra != 0).any()):
        fail("goldens: the mesh bounce's ST table has no contact force")
    a_tiny(torch, "mesh bounce's ST", st, ra, rb, state.owners.n)
    set_counts(saved)


FLAGSHIP_N = 524288  # the tool's default --n
FLAGSHIP_H = 5e-6
SET_DOWN_V = 0.05  # m/s: the wheel's approach to the clump it meets
SET_DOWN_CHUNKS = 4


def b_against_plain(torch, state, cfg, h):
    """Kernel B (with A's sums, as a step runs them) on `state`'s SS
    table (config `cfg`, step `h`) against its plain version, and both
    against B's plain rows evaluated and summed in float64 (the overlap
    is a difference of two numbers ~1e3 times larger, so every f32
    evaluation sits some 1e-4 of the largest owner wrench from the exact
    one, and B's FMAs round apart from torch's). Returns ({"kernel/plain", "f64/kernel", "f64/plain"}
    owner force and torque errors, relative to the largest; the friction
    history error against the plain version; kernel ms, plain ms, B's
    bound)."""
    from dem_engine_tpu_torch.ops import forces, segred
    from dem_engine_tpu_torch.ops.fused_force import (_wc_names,
                                                      fused_step_ss,
                                                      fused_step_ss_plain,
                                                      hertz_rows)

    ss, owners, model = state.ss, state.owners, cfg.force_model
    krec_w = forces.pack_kinematics(owners, world_omg=True)
    fk, tk, tab_k = fused_step_ss(ss, owners, h, cfg.voxel_size, model,
                                  krec_w)
    fp, tp, tab_p = fused_step_ss_plain(ss, owners, h, cfg.voxel_size,
                                        model, krec_w)
    live = ss.idA >= 0
    e_wc = max(rel_err(tab_p.wildcards[k][live].cpu(),
                       tab_k.wildcards[k][live].cpu())
               for k in tab_p.wildcards)
    lv = ss.fstat_a[0] >= 0
    oa, ob = (torch.where(lv, o, 0).long() for o in (ss.own_a, ss.own_b))
    wc = torch.stack([ss.wildcards[k] for k in _wc_names(ss, model)])
    ra, rb = hertz_rows(ss.fstat_a.double(), wc.double(),
                        krec_w[oa].double(), krec_w[ob].double(), h,
                        cfg.voxel_size, True)[:2]
    ex = (segred.seg_sum_plain(ra, ss.own_a, owners.n)
          + segred.seg_sum_plain(rb, ss.own_b_sorted, owners.n,
                                 perm=ss.perm_b)).cpu()
    del ra, rb
    sums = {"kernel": (fk.cpu(), tk.cpu()), "plain": (fp.cpu(), tp.cpu()),
            "f64": (ex[:, :3], ex[:, 3:])}
    errs = {f"{ref}/{got}": [rel_err(r, g) for r, g in zip(sums[ref],
                                                           sums[got])]
            for ref, got in (("kernel", "plain"), ("f64", "kernel"),
                             ("f64", "plain"))}
    ms = cuda_ms(torch, lambda: fused_step_ss(
        ss, owners, h, cfg.voxel_size, model, krec_w))
    pms = cuda_ms(torch, lambda: fused_step_ss_plain(
        ss, owners, h, cfg.voxel_size, model, krec_w))
    return errs, e_wc, ms, pms, bound(*bytes_B(ss, owners.n))


def hold_B(torch, tag, what, state, cfg, h):
    """``b_against_plain`` on `state`'s SS table, printed after `tag`:
    kernel B's owner sums no farther from the float64 ones than twice the
    plain version's, and the friction history within 1e-3 of it."""
    errs, e_wc, ms, pms, bnd = b_against_plain(torch, state, cfg, h)
    print(f"[{tag}] B on the {what} SS table (rows {state.ss.cap}, live "
          f"{int(state.ss.count)}), with A's sums, owner [force, torque] "
          f"errors of the largest: "
          + ", ".join(f"{k} {v[0]:.2e} {v[1]:.2e}" for k, v in errs.items())
          + f" (kernel B's from the float64 sums at most twice the plain "
          f"version's); friction history err {e_wc:.2e} (tol 1e-3); "
          f"kernels {ms:.3f} ms by events, plain {pms:.3f} ms, B's bound "
          f"{bnd[0]:.3g} ms ({bnd[1]})", flush=True)
    if not (all(k <= 2 * p for k, p in zip(errs["f64/kernel"],
                                           errs["f64/plain"]))
            and e_wc <= 1e-3):
        fail(f"{tag}: kernel B disagrees with its plain version on the "
             f"{what} SS table")


def flagship_settled(torch, s):
    """The settled terrain's kernels at its own shapes, before its clump
    file is written: C on both member tables of its two-class CD against
    the plain sweep, and B on its SS table against its plain version.
    Their launches here do not count. Returns the peak memory of the
    settle, before these checks."""
    saved = read_counts()
    mem = torch.cuda.max_memory_allocated()
    _, _, _, tabs = member_tables(torch, s.engine, s.state, s.params)
    c_on_members(torch, tabs, s.params.family_mask, s.engine.cfg.cap_ss,
                 "[flagship] C on the settled terrain's")
    del tabs
    hold_B(torch, "flagship", "settled", s.state, s.engine.cfg,
           float(s.params.h))
    set_counts(saved)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return mem


def wheel_drop(torch, s, wid):
    """How far wheel owner `wid` can go straight down before one of its
    triangles touches a sphere, by sphere tracing in float64: the spheres
    under its footprint are raised by their least gap to the triangles
    until it is below 1e-7 m. Returns (the distance, the owner of the
    sphere it meets)."""
    from dem_engine_tpu_torch.ops.narrowphase import closest_point_triangle
    from dem_engine_tpu_torch.solver import sphere_world_pos, tri_world_nodes

    st, vs = s.state, s._voxel_size
    tri = tri_world_nodes(st.owners, st.tris, vs)[st.tris.owner == wid]
    tri = tri.double()
    lo, hi = tri.reshape(-1, 3).amin(0), tri.reshape(-1, 3).amax(0)
    mid, half = (lo + hi) / 2, (hi[0] - lo[0]) / 2
    pos = sphere_world_pos(st.owners, st.spheres, vs).double()
    rad = st.spheres.radius.double()
    d = pos - mid
    under = ((d[:, 0].abs() < half + rad)
             & (d[:, 1].abs() < (hi[1] - lo[1]) / 2 + rad)
             & (d[:, 2] < 0) & (d[:, 0] ** 2 + d[:, 2] ** 2 > half ** 2))
    p, r = pos[under][:, None, :], rad[under]
    own = st.spheres.owner[under]
    a, b, c = (tri[None, :, k] for k in range(3))
    drop = 0.0
    for _ in range(200):
        q = p + torch.tensor([0.0, 0.0, drop], dtype=p.dtype,
                             device=p.device)
        gap = (q - closest_point_triangle(q, a, b, c)).norm(dim=-1)
        gap = gap.amin(1) - r
        i = int(gap.argmin())
        if float(gap[i]) < 1e-7:
            break
        drop += float(gap[i])
    return drop, int(own[i])


def set_down(torch, s, tracker, vx):
    """The wheel set down on the terrain under it: lowered until its tread
    meets the first sphere, moving down SET_DOWN_V faster than that
    sphere's clump (the bed's top is still falling with the wheel, so at
    equal speeds the two would not press; a Hertz impact at this speed
    lasts ~2 ms, longer than the set-down), then SET_DOWN_CHUNKS CD
    chunks on. Returns (the drop, the kernels' counts, per chunk [ST
    count, drawbar N, vertical load N, wheel z])."""
    wid = tracker.GetOwnerID()
    drop, touched = wheel_drop(torch, s, wid)
    p = tracker.Pos()
    tracker.SetPos([p[0], p[1], p[2] - drop])
    tracker.SetVel([vx, 0.0,
                    float(s.state.owners.vel[touched, 2]) - SET_DOWN_V])
    rows = []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(SET_DOWN_CHUNKS):
        s.DoDynamics(s.GetUpdateFreq() * FLAGSHIP_H)
        _, fs = tracker.GetContactForces()
        fs = np.asarray(fs).reshape(-1, 3)
        rows.append([int(s.state.st.count), float(fs[:, 0].sum()),
                     float(fs[:, 2].sum()), float(tracker.Pos()[2])])
    torch.cuda.synchronize()
    return drop, read_counts(), rows


def phase_flagship(torch, settle_steps, drive_steps, tmp, n=FLAGSHIP_N):
    """Phase 16: tools.flagship_wheeldp.run on the card: the layered GRC
    terrain of `n` clumps settled `settle_steps` steps, the contact gate,
    C and B held at the settled terrain's shapes, the clump CSV, the
    restore into a fresh solver with the wheel, and `drive_steps` steps
    at slip 0.3 in 6 chunks. At these lengths the wheel is still falling
    onto the collapsing bed, so it is then set down on the terrain
    (`set_down`) and must make wheel-terrain contact and a load; A is
    held on that step's SS, SA and ST rows. Returns the drive's solver,
    for the profile at the end of the run."""
    from dem_engine_tpu_torch.ops import forces
    from dem_engine_tpu_torch.ops.fused_force import hertz_rows_cuda
    from dem_engine_tpu_torch.solver import sphere_world_pos
    from dem_engine_tpu_torch.tools import flagship_wheeldp as flag

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the kernels' counts where the tool reports the end of a stage: the
    # settle's, and the drive's from the restore's report on
    at, settled = {}, {}

    def log(msg):
        stage = " ".join(msg.split()[:2])
        if stage in ("[prep] settle", "[wheel] restore+init"):
            at[stage] = read_counts()
        print(f"[flagship] {msg}", flush=True)

    reset_counts()
    try:
        rep, s, tracker = flag.run(
            n=n, settle=settle_steps * FLAGSHIP_H,
            drive=drive_steps * FLAGSHIP_H, slip=0.3, h=FLAGSHIP_H, out=tmp,
            device=DEVICE, verbosity="QUIET", keep=True, log=log,
            on_settled=lambda solver: settled.update(
                peak=flagship_settled(torch, solver)))
    except RuntimeError as e:
        fail(f"flagship: {e}")
    torch.cuda.synchronize()
    counts = read_counts()
    settle = at["[prep] settle"]
    drive = {k: v - at["[wheel] restore+init"][k] for k, v in counts.items()}
    print(f"[flagship] kernels a step: settle "
          + ", ".join(f"{k} {v / settle_steps:.3f}" for k, v in settle.items()
                      if v)
          + "; drive (6 queries included) "
          + ", ".join(f"{k} {v / drive_steps:.3f}" for k, v in drive.items()
                      if v), flush=True)
    mem = max(settled["peak"], torch.cuda.max_memory_allocated())
    print(f"[flagship] {n} clumps, h={FLAGSHIP_H:g}, K=25: init "
          f"{rep['t_init']:.2f} s, settle {rep['settle_steps']} steps "
          f"{rep['t_settle']:.2f} s ({rep['settle_ms_per_step']:.3f} "
          f"ms/step), checkpoint {rep['t_checkpoint']:.2f} s, restore "
          f"{rep['t_restore']:.2f} s, drive {rep['drive_steps']} steps "
          f"{rep['t_drive']:.2f} s ({rep['drive_ms_per_step']:.3f} "
          f"ms/step, queries included), total {rep['t_total']:.2f} s; peak "
          f"memory {mem / 2**30:.2f} GiB", flush=True)
    print(f"[flagship] two-class CD {rep['two_class_cd']}; after the "
          f"settle {rep['contacts_after_settle']} contacts (gate > "
          f"{flag.GATE * n:g}), tables [count, cap] {rep['settle_tables']}; "
          f"after the drive {rep['drive_tables']}", flush=True)
    print(f"[flagship] restore per template [file, solver] "
          f"{rep['restore_counts']}, largest position error "
          f"{rep['restore_max_pos_err']:.3g} m; kernels over the run "
          f"{counts}", flush=True)
    dx = rep["wheel_x"][-1] - rep["wheel_x0"]
    want = rep["vx"] * rep["sim_time"][-1]
    z0, z1 = rep["wheel_z0"], rep["wheel_z"][-1]
    print(f"[flagship] wheel x advance {dx:.6f} m against vx t "
          f"{want:.6f} m; z {z0:.6f} -> {z1:.6f} m (floor "
          f"{rep['floor_z']:.4f}); drawbar {rep['drawbar_N']} N; "
          f"wheel-terrain contacts {rep['wheel_contacts']}", flush=True)
    st = s.state
    pos = sphere_world_pos(st.owners, st.spheres, s._voxel_size)
    low = float((pos[:, 2] / st.spheres.radius).min())
    finite = all(bool(torch.isfinite(x).all()) for x in (
        st.owners.vel, st.owners.omg, st.owners.loc, st.owners.quat))
    print(f"[flagship] physics: finite={finite}, lowest sphere centre "
          f"{low:.3f} radii above the floor (need > 0.5), lost contacts "
          f"{int(st.lost_contacts)}", flush=True)
    if not rep["two_class_cd"]:
        fail("flagship: the terrain is not on the two-class CD")
    if any(a != b for a, b in rep["restore_counts"].values()) or sum(
            a for a, _ in rep["restore_counts"].values()) != n:
        fail("flagship: the restore lost or mixed clumps")
    if rep["restore_max_pos_err"] > 1e-6:
        fail("flagship: restored positions off the file's")
    if abs(dx - want) > 1e-3 * want:
        fail("flagship: the wheel did not advance by vx t")
    if not rep["floor_z"] < z1 < z0:
        fail("flagship: the wheel did not sink or went through the floor")
    if not np.isfinite(rep["drawbar_N"]).all():
        fail("flagship: drawbar not finite")
    if not finite or low <= 0.5:
        fail("flagship physics checks")
    if not all(counts[key] for key in ("A", "B", "B-extras", "C")):
        fail(f"flagship: a kernel of the path never launched: {counts}")

    drop, down, rows = set_down(torch, s, tracker, rep["vx"])
    steps = SET_DOWN_CHUNKS * s.GetUpdateFreq()
    print(f"[flagship] set-down: the wheel lowered {drop * 1e3:.3f} mm "
          f"onto the terrain, {steps} steps; per "
          f"chunk [ST count, drawbar N, vertical load N, wheel z m] {rows}; "
          f"kernels {down}", flush=True)
    st = s.state
    finite = all(bool(torch.isfinite(x).all()) for x in (
        st.owners.vel, st.owners.omg, st.owners.loc, st.owners.quat))
    if not (rows[-1][0] > 0 and any(r[2] > 0 for r in rows)
            and np.isfinite(rows).all()):
        fail("flagship: the wheel made no contact with the terrain by the "
             "set-down's last chunk")
    if not (finite and rows[-1][3] > rep["floor_z"]
            and not int(st.lost_contacts)):
        fail("flagship: set-down physics checks")
    if (down["A"] < 3 * steps or down["B"] != steps
            or down["C"] < 2 * SET_DOWN_CHUNKS):
        fail(f"flagship: set-down launches {down} off its path (A at least "
             f"{3 * steps}: SS, ST and SA each step; B {steps}; C at "
             f"least {2 * SET_DOWN_CHUNKS})")
    cfg, n_own = s.engine.cfg, st.owners.n
    rec_a, rec_b, _ = hertz_rows_cuda(
        st.ss, forces.pack_kinematics(st.owners, world_omg=True),
        float(s.params.h), cfg.voxel_size, cfg.force_model)
    hold_A(torch, "flagship", "kernel B's SS", st.ss, rec_a, rec_b, n_own)
    del rec_a, rec_b
    pass_A(torch, s, "flagship", ("sa", "st"))
    return s


def phase_mesh(torch, n_clumps, k, warm, steps, card):
    """Phase 17: the multi-device layer at world size 1 over NCCL (the box
    has one card). The mono bed with the spatial refresh on, through
    Engine(cfg, mesh): buckets at a quarter of their auto size, so the
    first refresh takes the OVF_SPATIAL_BUCKET growth; on the settled
    state the spatial SS pair set identical to kernel C's global sweep
    and to the plain sweep's, the SA pair set identical to the refresh
    without the mesh, and kernel C on the received rows identical to the
    plain sweep there (``mesh_pairs``); the row exchange, its answer and
    the record fetch over NCCL (``mesh_collectives``); each rank's rows
    and home rows, and the home split the table would take on 2, 4 and 8
    ranks (``mesh_homes``); one step's owner wrench from the same state
    with and without the mesh (``mesh_wrench``); 4 chunks from that
    state against Engine(cfg) with no mesh, bit for bit or else at the
    parity phase's tolerances with the wrench within 1e-6 (Crr = 0);
    then the timed chunks, a refresh's ms and peak memory beyond the
    state, and launch counts of both. Returns what the profile at the
    end needs."""
    from dem_engine_tpu_torch import Engine, build_case
    from dem_engine_tpu_torch.ops.voxel import decode_host
    from dem_engine_tpu_torch.parallel import (gather_state, make_mesh,
                                               shard_state)
    from dem_engine_tpu_torch.solver import _GROWTH, spatial_capx_auto

    torch.cuda.empty_cache()
    mesh = make_mesh(1, device=DEVICE)
    print(f"[mesh] world size {mesh.size}, backend {mesh.backend}, device "
          f"{mesh.device}; {card}", flush=True)
    if mesh.backend != ("nccl" if DEVICE == "cuda" else "gloo"):
        fail("the mesh on the card must run NCCL")
    cfg, state, params = build_case(n_clumps, update_freq=k, device=DEVICE)
    params = params.replace(pair_props={
        **params.pair_props, "Crr": torch.zeros((1, 1), device=DEVICE)})
    n_sph = state.spheres.n
    auto = spatial_capx_auto(n_sph, mesh.size)
    cfg = dataclasses.replace(cfg, spatial_refresh=True,
                              spatial_capx=auto // 4)
    eng0 = Engine(cfg)
    state = eng0.advance(state, params, warm, k)
    params_k = params.replace(max_drift=torch.tensor(k, dtype=torch.int32,
                                                     device=DEVICE))

    # the growth path, on the settled state
    events = []
    eng = Engine(cfg, mesh=mesh)
    eng.log = lambda level, msg: events.append(f"{level}: {msg}")
    reset_counts()
    local = eng.refresh(shard_state(state, mesh), params_k)
    c_growth = read_counts()["C"]
    want, capx = cfg.spatial_capx, []
    while want < eng.cfg.spatial_capx:
        want = int(want * _GROWTH) + 128
        capx.append(want)
    for e in events:
        print(f"[mesh] growth event: {e}", flush=True)
    print(f"[mesh] spatial_capx {cfg.spatial_capx} (a quarter of the auto "
          f"{auto}) -> {eng.cfg.spatial_capx} in {eng.timers['grows']} "
          f"growths (the JAX formula's ladder: {capx}), {c_growth} C "
          f"launches", flush=True)
    if not (events and eng.timers["grows"] >= 1
            and eng.cfg.spatial_capx == want and c_growth
            == eng.timers["grows"] + 1):
        fail("the spatial bucket growth did not run as the JAX engine's")

    mesh_pairs(torch, mesh, eng, eng0, state, local, params_k, card)
    mesh_collectives(torch, mesh, local, state.spheres, card)
    mesh_homes(torch, local, n_sph, eng.cfg, card)
    e_w = mesh_wrench(torch, mesh, eng, eng0, state, params_k, n_clumps,
                      card)

    # 4 chunks from the settled state, with and without the mesh
    def owners(st):
        o = st.owners
        return (o.vel.cpu().numpy(), o.omg.cpu().numpy(),
                decode_host(o.vox.cpu().numpy(), o.loc.cpu().numpy(),
                            cfg.voxel_size), o.vox.cpu().numpy(),
                o.loc.cpu().numpy())

    ref = owners(Engine(eng0.cfg).advance(state, params, 4 * k, k))
    out = owners(gather_state(Engine(eng.cfg, mesh=mesh).advance(
        shard_state(state, mesh), params, 4 * k, k), mesh))
    e_v, e_o = rel_err(ref[0], out[0]), rel_err(ref[1], out[1])
    e_p = float(np.abs(ref[2] - out[2]).max() / cfg.voxel_size)
    bits = all(np.array_equal(a, b) for a, b in zip(ref, out))
    print(f"[mesh] 4 chunks of K={k} from the settled state, mesh against "
          f"no mesh (Crr=0): bit for bit {bits}; vel err {e_v:.2e} omg err "
          f"{e_o:.2e} position err {e_p:.2e} voxel (tol 2e-4, 2e-4, 1e-3; "
          f"where not bit for bit, one step's wrench within 1e-6: "
          f"{e_w:.2e})", flush=True)
    if not (bits or (e_w <= 1e-6 and e_v <= 2e-4 and e_o <= 2e-4
                     and e_p <= 1e-3)):
        fail("the mesh Engine disagrees with the Engine without a mesh")

    # timed: chunks and refreshes, without the mesh and with it
    runs = {}
    for tag, e, st, m in (("no mesh", eng0, state, None),
                          ("mesh", eng, local, mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = e.refresh_attempts
        reset_counts()
        t0 = time.perf_counter()
        st = e.advance(st, params, steps, k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, refreshes = read_counts(), e.refresh_attempts - a0
        mem = torch.cuda.max_memory_allocated()
        # one refresh's peak beyond what is allocated before it (the
        # state and the retained tables)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        e.refresh(st, params_k)
        torch.cuda.synchronize()
        one = torch.cuda.max_memory_allocated() - held
        ref_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            e.refresh(st, params_k)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t1) * 1e3)
        runs[tag] = (e, st, counts)
        print(f"[mesh] {tag}: {n_clumps} clumps, K={k}, {steps} steps: "
              f"{dt * 1e3 / steps:.3f} ms/step, a refresh "
              f"{float(np.median(ref_ms)):.3f} ms (median of 5; "
              f"{', '.join(f'{x:.3f}' for x in ref_ms)}); one refresh's "
              f"peak {one / 2**30:.3f} GiB beyond the {held / 2**30:.3f} "
              f"GiB held; run peak {mem / 2**30:.2f} GiB; launches {counts} "
              f"({refreshes} refresh attempts); {card}", flush=True)
        for kind in ("ss", "sa"):
            t = getattr(st, kind)
            print(f"[mesh] {tag}: rank {getattr(m, 'rank', 0)} {kind} table "
                  f"{t.cap} rows, {int(t.count)} home rows (cap "
                  f"{getattr(e.cfg, 'cap_' + kind)})", flush=True)
        expect = {"A": 2 * steps, "B": steps, "B-extras": 0, "B-ub": 0,
                  "C": refreshes, "D": 0, "lists": 0}
        if counts != expect or refreshes < steps // k:
            fail(f"{tag}: launch counts {counts}, expected {expect}")
    physics(torch, gather_state(runs["mesh"][1], mesh), cfg.voxel_size,
            "mesh")
    return mesh, runs, params_k


def mesh_collectives(torch, mesh, local, spheres, card):
    """The row exchange of a mesh refresh at world size 1 (NCCL): the
    SS table's rows sent to rank 0 with the dead ones dropped must come
    back as the live rows in order, the answer must put them back in
    place (zeros on the dead), and a fetch of the B-side sphere records
    through the exchange must equal reading them in place. One rank's
    refresh needs none of it (every row is home, every record whole);
    this holds the collectives a mesh of several cards runs."""
    from dem_engine_tpu_torch.parallel import mesh as pmesh

    t = local.ss
    live = t.idA >= 0
    x = torch.stack([t.idA, t.idB], 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, plan = mesh.exchange(x, torch.where(live, 0, mesh.size))
    back = mesh.answer(rows, plan)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = pmesh.fetch_record(spheres, t.idB, mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ids = t.idB[live].long()
    same = {"exchange": torch.equal(rows, x[live]),
            "answer": torch.equal(back, torch.where(live[:, None], x, 0)),
            "fetch": all(torch.equal(getattr(got, f)[live],
                                     getattr(spheres, f)[ids])
                         for f in ("owner", "relpos", "radius", "mat"))}
    print(f"[mesh] {mesh.backend} exchange of {x.shape[0]} rows "
          f"({rows.shape[0]} live) and its answer {(t1 - t0) * 1e3:.3f} "
          f"ms, the fetch of their B spheres {(t2 - t1) * 1e3:.3f} ms: "
          f"{same}; {card}", flush=True)
    if not all(same.values()):
        fail(f"the mesh's row exchange over NCCL is wrong: {same}")


def mesh_homes(torch, local, n_sph, cfg, card):
    """Each row's home rank is the index shard of its A-side sphere: the
    rows of the bed's SS and SA tables each rank would hold on 2, 4 and
    8 ranks, against cap / D."""
    from dem_engine_tpu_torch.parallel.mesh import home_of

    for kind in ("ss", "sa"):
        t = getattr(local, kind)
        ids = t.idA[t.idA >= 0]
        cap = getattr(cfg, "cap_" + kind)
        for d in (2, 4, 8):
            per = torch.bincount(home_of(ids, n_sph, d), minlength=d)
            print(f"[mesh] {kind} home rows on {d} ranks: "
                  f"{per.tolist()}, the fullest {int(per.max())} = "
                  f"{float(per.max()) / max(float(per.float().mean()), 1):.3f}"
                  f"x the mean, {float(per.max()) * d / cap:.3f} of cap / D "
                  f"({cap // d}); {card}", flush=True)


def mesh_wrench(torch, mesh, eng, eng0, state, params_k, n_clumps, card):
    """One step from the same settled state after a refresh with the mesh
    and one without: the clumps' contact accelerations (their wrench over
    one mass) bit for bit, or how far apart relative to the largest (the
    two tables hold the same pairs, and rows that tie on (own_a, own_b)
    may sum in another order). Returns that distance."""
    from dem_engine_tpu_torch.parallel import gather_state, shard_state
    from dem_engine_tpu_torch.solver import run_steps

    ref = run_steps(eng0.refresh(state, params_k), params_k, eng0.cfg, 1)
    got = gather_state(run_steps(
        eng.refresh(shard_state(state, mesh), params_k), params_k, eng.cfg,
        1, mesh=mesh), mesh)
    errs, bits = [], True
    for f in ("lin_acc", "ang_acc"):
        a = getattr(ref.owners, f)[:n_clumps]
        b = getattr(got.owners, f)[:n_clumps]
        bits &= torch.equal(a, b)
        errs.append(float((a - b).abs().max() / a.abs().max()))
    print(f"[mesh] one step's clump wrench, mesh against no mesh: bit for "
          f"bit {bits}; force {errs[0]:.2e}, torque {errs[1]:.2e} of the "
          f"largest (tol 1e-6); {card}", flush=True)
    return 0.0 if bits else max(errs)


def mesh_pairs(torch, mesh, eng, eng0, state, local, params_k, card):
    """Phase 17's pair sets on the settled state: the spatial search's
    (the mesh Engine's refresh, `local`), kernel C's global sweep (the
    Engine without a mesh) and the plain sweep over every sphere must be
    one set. The received rows are then built again at the grown bucket
    size, as the spatial search builds them (padding rows included, left
    out as non-members): kernel C on them must equal the plain sweep row
    for row, and the pairs the rank keeps of the plain sweep's must be
    that set too. Check launches are not counted (the caller resets the
    counts before each path it reads)."""
    from dem_engine_tpu_torch.ops import binning
    from dem_engine_tpu_torch.parallel import gather_state, spatial
    from dem_engine_tpu_torch.solver import ss_search_inputs

    n_sph, cfg, mask = state.spheres.n, eng.cfg, params_k.family_mask
    whole = eng0.refresh(state, params_k)
    got = gather_state(local, mesh)
    sets = {"spatial": ss_keys(torch, got.ss, n_sph),
            "C global": ss_keys(torch, whole.ss, n_sph)}
    n_a = state.anals.n
    sa_same = torch.equal(ss_keys(torch, got.sa, n_a),
                          ss_keys(torch, whole.sa, n_a))
    print(f"[mesh] SA pair set with the mesh {int(got.sa.count)}, without "
          f"{int(whole.sa.count)}: identical {sa_same}", flush=True)
    if not (sa_same and int(got.sa.count) > 0):
        fail("the mesh's SA pairs differ from the refresh without a mesh")
    q = ss_search_inputs(state, params_k, cfg.voxel_size)
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     n_sph)
    t0 = time.perf_counter()
    pa, pb, pn = binning.sweep_table(tab, n_sph, mask, q["nb_cd"],
                                     eng0.cfg.cap_ss, int(tab.max_occ))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    live = pa >= 0
    sets["plain global"] = torch.sort(pa[live].long() * n_sph
                                      + pb[live].long()).values

    # the rows the spatial search received, at the grown bucket size
    q = ss_search_inputs(state, params_k, cfg.voxel_size, relabel=False)
    rec, resident, bovf = spatial.exchange(
        q["pos"], q["reach"], q["owner"], q["family"], q["bin_size"],
        params_k.domain, mesh, cfg.spatial_capx)
    c_cap = spatial.received_cap(cfg.cap_ss, n_sph, rec.shape[0])
    ka, kb, kn, rtab = spatial.search_received(rec, mask, q["bin_size"],
                                               q["nb_cd"], c_cap)
    ra, rb, rn = binning.sweep_table(rtab, rec.shape[0], mask, q["nb_cd"],
                                     c_cap, int(rtab.max_occ))
    same_c = (int(kn) == int(rn) and torch.equal(ka, ra)
              and torch.equal(kb, rb))
    ia, ib, kept = spatial.keep_resident(rec, resident, ra, rb,
                                         q["bin_size"], q["nb_cd"],
                                         cfg.cap_ss)
    live = ia >= 0
    sets["plain received"] = torch.sort(ia[live].long() * n_sph
                                        + ib[live].long()).values
    n_valid = int(spatial.unpack(rec)[5].sum())
    print(f"[mesh] received rows {rec.shape[0]} ({n_valid} spheres, "
          f"{rec.shape[0] - n_valid} padding rows as non-members; bucket "
          f"overflow {bool(bovf)}); kernel C on them {int(kn)} pairs, the "
          f"plain sweep {int(rn)} (table {c_cap} rows, max occupancy "
          f"{int(rtab.max_occ)}): identical row for row {same_c}; kept "
          f"{int(kept)}", flush=True)
    ref = sets["C global"]
    same = {k: bool(v.shape == ref.shape and torch.equal(v, ref))
            for k, v in sets.items()}
    print(f"[mesh] settled state pair sets: "
          + ", ".join(f"{k} {v.numel()}" for k, v in sets.items())
          + f" (counts: spatial {int(got.ss.count)}, C global "
          f"{int(whole.ss.count)}, plain global {int(pn)}); identical "
          f"{all(same.values())}; the plain global sweep took "
          f"{plain_s * 1e3:.1f} ms; {card}", flush=True)
    if not same_c or bool(bovf) or n_valid != n_sph:
        fail("kernel C on the received rows differs from the plain sweep")
    if not (all(same.values()) and int(got.ss.count) == int(whole.ss.count)
            == int(pn) == int(kept) == ref.numel() > 0):
        fail(f"the spatial, C global and plain pair sets differ: {same}")


def mesh_device(torch, mesh, runs, params_k, card, n=5):
    """The profile of phase 17: launches and device time a step with the
    mesh and without it (the collectives add launches), then those of
    one refresh by operation."""
    from dem_engine_tpu_torch.solver import run_steps

    for tag, (e, st, _) in runs.items():
        rows = device_rows(torch, lambda: e.refresh(st, params_k))
        if rows:
            print(f"[mesh device] {tag}: one refresh, device busy "
                  f"{sum(r[0] for r in rows):.3f} ms in "
                  f"{sum(r[1] for r in rows):g} launches; {card}",
                  flush=True)
            for ms, cnt, name in rows[:10]:
                print(f"[mesh device]   {ms:.3f} ms/refresh  x{cnt:g}  "
                      f"{name[:70]}", flush=True)
    for tag, (e, st, _) in runs.items():
        m = mesh if tag == "mesh" else None
        rows = device_rows(torch, lambda: run_steps(st, params_k, e.cfg, n,
                                                    mesh=m), per=n)
        if not rows:
            print(f"[mesh device] {tag}: the profiler recorded no device "
                  "time: not measured", flush=True)
            continue
        coll = [r for r in rows if "nccl" in r[2].lower()]
        print(f"[mesh device] {tag}: {sum(r[1] for r in rows):g} launches "
              f"and {sum(r[0] for r in rows):.3f} ms of device time a step, "
              f"{sum(r[1] for r in coll):g} of them NCCL "
              f"({sum(r[0] for r in coll):.3f} ms); {card}", flush=True)
        for ms, cnt, name in coll[:4]:
            print(f"[mesh device]   {ms:.3f} ms/step  x{cnt:g}  {name[:70]}",
                  flush=True)
    mesh.close()


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
    "lists": ("unique_fetch_lists", "dem_engine_tpu_torch/csrc/uniq_layout.cu",
              "dem_engine_tpu/ops/forces.py:165 _uniq_layout"),
}
PHASES = ("kernels", "parity", "main", "poly", "breakdown", "api",
          "families", "uniq", "output", "custom", "bonded", "rest", "demos",
          "goldens", "flagship", "mesh")
# phases a caller may ask for that the default run leaves out
EXTRA_PHASES = ("goldens-long",)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clumps", type=int, default=262144)
    ap.add_argument("--parity-clumps", type=int, default=4096)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--flagship-settle", type=int, default=2000,
                    help="settle steps of the flagship (the tool's 0.05 s: "
                         "10000)")
    ap.add_argument("--flagship-drive", type=int, default=3000,
                    help="drive steps of the flagship (the tool's 0.3 s: "
                         "60000)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES + EXTRA_PHASES):
        fail(f"unknown phases "
             f"{sorted(set(phases) - set(PHASES + EXTRA_PHASES))}")

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    # the package from the checkout; the demos' scenes from beside its tests
    sys.path[:0] = [root, os.path.join(root, "tests")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_env(torch)
    phase_build()
    kern = (phase_kernels(torch, args.clumps, args.k) if "kernels" in phases
            else None)
    if "parity" in phases:
        phase_parity(torch, args.parity_clumps)
    main_counts = api_counts = None
    if "main" in phases:
        main_counts = phase_main(torch, args.clumps, args.k, args.warm,
                                 args.steps)
    if "poly" in phases:
        torch.cuda.empty_cache()
        phase_poly(torch, args.clumps, args.k, args.warm, args.steps)
    if "api" in phases:
        api_counts = phase_api(torch, args.clumps, args.k, args.steps)
        phase_api_poly(torch, args.clumps, args.k, args.steps)
    if "families" in phases:
        phase_families(torch, args.clumps, args.k, args.steps)
    if "output" in phases:
        phase_output(torch, args.clumps, args.k, args.steps)
    if "custom" in phases:
        phase_custom(torch, args.clumps, args.k, args.steps)
    if "bonded" in phases:
        phase_bonded(torch, bond_side(args.clumps), args.k, args.steps)
    rest = None
    if "rest" in phases:
        t0 = time.perf_counter()
        rest = phase_rest(torch, args.clumps, args.k, steps=args.steps)
        print(f"[rest] phase 14 (timed part): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    demos = flagship = None
    if "demos" in phases:
        import tempfile

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_demos_") as d:
            demos = phase_demos(torch, d)
        print(f"[demos] phase 15 (timed part): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if "goldens" in phases or "goldens-long" in phases:
        import torch_behaviour as tb

        names = {g.name for g in tb.GOLDENS if (
            g.name in GOLDENS_DEFAULT if "goldens-long" not in phases
            else "goldens" in phases or g.name not in GOLDENS_DEFAULT)}
        phase_goldens(torch, names, kernels="goldens" in phases)
    if "flagship" in phases:
        import tempfile

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_flagship_") as d:
            flagship = phase_flagship(torch, args.flagship_settle,
                                      args.flagship_drive, d)
        print(f"[flagship] phase 16 (timed part): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    meshed = None
    if "mesh" in phases:
        t0 = time.perf_counter()
        meshed = phase_mesh(torch, args.clumps, args.k, args.warm,
                            args.steps, card)
        print(f"[mesh] phase 17 (timed part): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    # torch.profiler only from here on, so that no timed run follows a
    # profile in its process; the breakdowns settle their beds anew, so
    # no timed run shares the card's memory with them either
    if kern:
        phase_device_times(torch, args.clumps, args.k, kern)
    if "uniq" in phases:
        phase_uniq(torch, args.clumps, args.k)
    if "breakdown" in phases and "main" in phases:
        phase_breakdown(torch, *settled_case(torch, args.clumps, args.warm,
                                             update_freq=args.k), args.k)
    if "breakdown" in phases and "poly" in phases:
        torch.cuda.empty_cache()
        poly = settled_case(torch, args.clumps, args.warm,
                            update_freq=args.k, **POLY)
        phase_breakdown(torch, *poly, args.k, tag="poly breakdown")
        poly_refresh_split(torch, *poly, args.k)
        del poly
    if "breakdown" in phases and "api" in phases:
        for label, uniq in API_RUNS:
            torch.cuda.empty_cache()
            s = api_solver(args.clumps, args.k, uniq)
            s.DoDynamics(args.k * API_H)
            phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                            tag=f"api breakdown, {label}")
            del s
        torch.cuda.empty_cache()
        s = api_poly_solver(args.clumps, args.k)
        s.DoDynamics(args.k * API_H)
        phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                        tag="api breakdown, poly")
        del s
    if "breakdown" in phases and "families" in phases:
        torch.cuda.empty_cache()
        s, _, _ = families_solver(args.clumps, args.k,
                                  (2 * args.k + args.steps) * API_H)
        s.DoDynamics(args.k * API_H)
        phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                        tag="families breakdown")
        del s
    if "custom" in phases:
        torch.cuda.empty_cache()
        s = custom_solver(args.clumps, args.k)
        s.DoDynamics(args.k * API_H)
        if "breakdown" in phases:
            phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                            tag="custom breakdown")
        custom_device(torch, s)
        del s
    if "breakdown" in phases and "bonded" in phases:
        torch.cuda.empty_cache()
        s, _, top, pos, _ = bonded_solver(bond_side(args.clumps), args.k)
        cut_block(s, top, pos)
        s.DoDynamics(args.k * BOND_H)
        phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                        tag="bonded breakdown")
        del s
    if "output" in phases:
        phase_output_device(torch, args.clumps, args.k)
    if rest:
        s, c_tabs = rest
        rest_device(torch, c_tabs)
        del c_tabs
        if "breakdown" in phases:
            phase_breakdown(torch, s.engine, s.state, s.params, args.k,
                            tag="rest breakdown")
        del s, rest
    if demos:
        demos_device(torch, demos)
        del demos
    if flagship is not None:
        s = flagship
        rows = device_rows(torch, lambda: s.DoDynamics(25 * FLAGSHIP_H))
        print(f"[flagship device] one chunk (refresh + 25 steps): "
              f"{sum(r[1] for r in rows) / 25:.1f} launches and "
              f"{sum(r[0] for r in rows) / 25:.3f} ms of device time a "
              f"step", flush=True)
        if "breakdown" in phases:
            phase_breakdown(torch, s.engine, s.state, s.params, 25,
                            tag="flagship breakdown")
            poly_refresh_split(torch, s.engine, s.state, s.params, 25)
        del s, flagship
    if meshed:
        mesh_device(torch, *meshed, card)
        del meshed
    print(card)
    if kern and main_counts and api_counts:
        # each kernel's launches on the path that runs it: A, B and C on
        # the main path, B-ub and the lists launch on the API's steps with
        # unique fetch on, B-extras in the contact query; D has no caller
        launches = dict(main_counts, **{
            "B-ub": api_counts["ub"]["B-ub"],
            "lists": api_counts["ub"]["lists"],
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
