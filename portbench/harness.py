"""One run of one cell: set-up, the measured window, the traced readings
and the check of the outputs.

Everything a cell is sits in files that ``BENCHMARK.json`` names: its
configuration (``configs/``), its traffic (``traffic/``) and, on a traced
run, one reader per per-layer metric (``metrics/<name>.py``). A later
cell, configuration, traffic mix or metric is new files and entries.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import capture, lattice, roofline, scene, trace
from .reference import compare
from .reference.follow import follow
from .reference.scene import Scene


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench_dir(bench: dict, root: Path) -> Path:
    """The folder of the benchmark's data: traffic/, metrics/ and
    limits/ (one file of limits per configuration)."""
    return root / bench["paths"][0]


def resolve(bench: dict, workload: str, root: Path) -> dict:
    """The cell's entry with its configuration and traffic loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_path = root / conf["file"]
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads((bench_dir(bench, root) / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return dict(entry=w, config=cfg, config_dir=cfg_path.parent,
                traffic=traffic)


def reader(name: str, metrics_dir: Path):
    """The per-layer metric's reader, ``metrics/<name>.py``'s read()."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_for(bench: dict, workload: str) -> list:
    """The per-layer metrics a traced run of the cell reports."""
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(s, traffic: dict, seconds: float, dev):
    """Whole DoDynamics frames until `seconds` have passed, between two
    synchronised host-clock readings (DoDynamics ends in a sync), with
    the engine's chunk timers of the window and each frame's seconds."""
    frame_s = int(traffic["frame_steps"]) * float(s._h)
    s.engine.clear_timers()
    frames = failed = 0
    walls = []
    _sync(dev)
    t0 = t = time.perf_counter()
    while True:
        try:
            s.DoDynamics(frame_s)
        except RuntimeError as e:  # divergence, growth that did not end
            failed += 1
            print(f"[portbench] frame {frames} raised: {e}", flush=True)
            break
        frames += 1
        walls.append(time.perf_counter() - t)
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(frames=frames, failed=failed, wall_s=wall,
                steps=frames * int(traffic["frame_steps"]),
                frame_walls=walls, timers=dict(s.engine.read_timers()))


def _chunk_params(s, k):
    from dem_engine_tpu_torch.defines import F, I

    return s.params.replace(
        max_drift=torch.tensor(k, dtype=I, device=s.device),
        bin_factor=torch.tensor(s.engine.bin_factor, dtype=F,
                                device=s.device))


def kernel_bytes(st, cfg) -> dict:
    """Bytes and operations of a step's kernels on the state's tables:
    {"A": [(bytes, ops) of each table's sums], "B": (bytes, ops)} (B on
    the built-in Hertz path only), from live rows and owners alone."""
    from dem_engine_tpu_torch.ops import forces

    n = st.owners.n
    ss, sa = st.ss, st.sa
    live = ss.idA >= 0
    n_ss, n_sa = int(live.sum()), int((sa.idA >= 0).sum())
    out = {"A": [roofline.bytes_A(n_ss, n, False),
                 roofline.bytes_A(n_sa, n, True)]}
    if forces.fused_ss(cfg.force_model):
        touched = int(torch.unique(torch.cat(
            [ss.own_a[live], ss.own_b[live]])).numel())
        out["B"] = roofline.bytes_B(n_ss, touched)
    return out


def post_window_profiles(s, traffic: dict, dev) -> dict:
    """One refresh of the window's final state (the engine's, as a chunk
    makes it) and K steps after it, each under the profiler, their
    results dropped."""
    from dem_engine_tpu_torch import solver

    k = int(traffic["cd_update_freq"])
    cfg = s.engine.cfg
    pk = _chunk_params(s, k)
    out = {}
    rp = trace.profiled(
        lambda: out.setdefault("st", s.engine.refresh(s.state, pk)), dev)
    st = out["st"]
    sp = trace.profiled(
        lambda: solver.run_steps(st, pk, cfg, k, h=float(s._h)), dev)
    del out, st
    if sp is not None:
        sp.update(steps=k)
    return dict(refresh_profile=trace.read(rp), step_profile=trace.read(sp))


def _start_copy(s, n):
    """The clumps as Initialize made them, copied to the host."""
    o = capture.owners_plain(s.state.owners, s.engine.cfg.voxel_size, n)
    return {k: v.detach().to("cpu", copy=True) for k, v in o.items()}


def check(cell: dict, seed: int, start: dict, inputs: dict, outputs: dict,
          dev, dtype=torch.float64) -> tuple:
    """The compared numbers and their detail: the reference in `dtype`
    follows the captured refresh and step; the start is held to the
    scene the configuration and the seed make."""
    cfg, traffic = cell["config"], cell["traffic"]
    sc = Scene(cfg, traffic, dev, dtype)
    ref = follow(sc, inputs["owners"], inputs["old"])
    numbers, detail = compare.compare(sc, ref, inputs["old"], outputs)
    geo = lattice.bed(cfg)
    numbers["start_err"] = compare.start_error(
        sc, {k: v.to(dev) for k, v in start.items()},
        torch.as_tensor(lattice.initial_velocities(cfg, seed), device=dev),
        torch.as_tensor(geo["pos"], device=dev))
    return numbers, detail


def with_material(cfg: dict, material: dict | None) -> dict:
    """The configuration with some of its material's values replaced."""
    if not material:
        return cfg
    out = copy.deepcopy(cfg)
    out["material"].update(material)
    return out


def control_outputs(cell: dict, inputs: dict, dev, dtype,
                    material=None, pairs=None) -> dict:
    """The control: the reference, computed in `dtype` and with
    `material`'s values in the configuration's place, put in the
    program's place; with `pairs`, its step on those pairs in place of
    its own search. The same structure as ``capture.plain``'s
    outputs."""
    sc = Scene(with_material(cell["config"], material), cell["traffic"],
               dev, dtype)
    r = follow(sc, inputs["owners"], inputs["old"], pairs)
    a, b, _ = r["found"]["ss"]
    rows = {k: dict(a=v["a"], b=v["b"], force=v["force"], tq_a=v["tq_a"],
                    tq_b=v["tq_b"], wc=v["wc"])
            for k, v in r["rows"].items()}
    n = sc.n
    after = dict(r["after"])
    # the position the control keeps, less the one it started from
    pos0 = r["owners"]["pos"][:n]
    after["disp"] = (pos0 + after["disp"]) - pos0
    return dict(pairs=dict(ss=(a, b), sa=r["found"]["sa"][0]), rows=rows,
                F=r["F"], T=r["T"], after=after)


def control_start(cell: dict, seed: int, dev, dtype) -> dict:
    """The control's start: the configuration's scene in `dtype`."""
    cfg = cell["config"]
    sc = Scene(cfg, cell["traffic"], dev, dtype)
    n = sc.n
    q = torch.zeros((n, 4), dtype=dtype, device=dev)
    q[:, 0] = 1
    return dict(
        pos=torch.as_tensor(lattice.bed(cfg)["pos"], device=dev).to(dtype),
        vel=torch.as_tensor(lattice.initial_velocities(cfg, seed),
                            device=dev).to(dtype),
        quat=q, mass=torch.full((n,), sc.mass, dtype=dtype, device=dev),
        moi=sc.moi.expand(n, 3).to(dtype))


def run(bench: dict, root: Path, workload: str, seed: int, seconds: float,
        trace_on: bool, device: str, t_start: float, clock,
        also=()) -> tuple:
    """One run; returns the result line's object (correct, attempted,
    failed, metrics, device, with a traced run breakdown, and
    `checks` last) and the extra readings (the check's detail among
    them). `clock()` reads the clock `t_start` was taken on. For each
    (label, dtype, material, search) of `also`, the reference computed
    in that dtype, with those material values, is judged too, in the
    program's place, into the detail's ``controls`` under its label:
    with `search` false, its step runs on the program's pairs."""
    dev = torch.device(device)
    cell = resolve(bench, workload, root)
    cfg, traffic = cell["config"], cell["traffic"]
    n = int(cfg["n_clumps"])
    s = scene.build_solver(cfg, traffic, seed, device, cell["config_dir"])
    if s.engine.auto_freq or s.engine.auto_bin:
        raise RuntimeError("the traffic asks for the tuners off")
    start = _start_copy(s, n)
    frame_s = int(traffic["frame_steps"]) * float(s._h)
    s.DoDynamics(frame_s)  # the warm frame
    _sync(dev)
    setup_s = clock() - t_start
    win = window(s, traffic, seconds, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    frame_prof = None
    if trace_on:
        # the frame after the window, under the profiler (whose start and
        # stop take seconds, which the window must not hold), with the
        # bytes and operations of kernels B and A on its last tables
        frame_prof = trace.read(trace.profiled(
            lambda: s.DoDynamics(frame_s), dev))
        if frame_prof is not None:
            frame_prof.update(steps=int(traffic["frame_steps"]),
                              bytes=kernel_bytes(s.state, s.engine.cfg))
    rec = dict(window=win, frame_profile=frame_prof,
               state_bytes=s.GetDeviceMemUsageDynamic(),
               kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"))
    if trace_on:
        rec.update(post_window_profiles(s, traffic, dev))
    # the check frame: the same call the window makes, captured
    with capture.Capture() as cap:
        s.DoDynamics(frame_s)
    inputs, outputs = capture.plain(cap, s.engine.cfg.voxel_size, n)
    del cap, s
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, detail = check(cell, seed, start, inputs, outputs, dev)
    detail["controls"] = {}
    for label, dt, material, search in also:
        detail["controls"][label] = check(
            cell, seed, control_start(cell, seed, dev, dt), inputs,
            control_outputs(cell, inputs, dev, dt, material,
                            None if search else outputs["pairs"]), dev)[0]
    limits = json.loads((bench_dir(bench, root) / "limits"
                         / f"{cell['entry']['config']}.json").read_text())
    checks = {k: dict(value=float(numbers[k]), limit=float(limits[k]))
              for k in limits}
    correct = (win["failed"] == 0 and win["frames"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    rate = n * win["steps"] / win["wall_s"] if win["wall_s"] > 0 else 0.0
    metrics = {}
    if trace_on:
        for m in per_layer_for(bench, workload):
            v = reader(m["name"], bench_dir(bench, root) / "metrics")(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(clump_steps_per_s=rate, peak_mem_gib=peak / 2**30,
                      setup_s=setup_s)
        for m in bench["end_to_end"]:
            metrics[m["name"]] = dict(value=float(values[m["name"]]),
                                      unit=m["unit"])
    result = dict(correct=bool(correct),
                  attempted=win["frames"] + win["failed"],
                  failed=win["failed"], metrics=metrics,
                  device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                              kind=rec["kind"], count=cell["entry"]["chips"],
                              memory_peak_bytes=int(peak)))
    if trace_on and frame_prof is not None and frame_prof["events"]:
        result["device"]["busy_s"] = trace.busy_us(
            frame_prof["events"]) * 1e-6
        result["device"]["window_s"] = frame_prof["wall_s"]
        result["breakdown"] = trace.breakdown(frame_prof["events"])
    result["checks"] = checks
    extra = dict(detail=detail, setup_s=setup_s, window=win,
                 profiled_frame_s=frame_prof["wall_s"] if frame_prof
                 else None,
                 clump_steps_per_s=rate)
    return result, extra
