"""Time variants of kernels B-ub, C and the lists launch on one NVIDIA GPU.

    python3 -m dem_engine_tpu_torch.tools.redesign_variants [--clumps 262144]

from the root of the repository (it takes its beds and tables from
chip_smoke.py). Each variant is one source of csrc/ built with other
values of its build-time switches: ``-DUB_...`` for kernel B-ub in
fused_force.cu (CTAs per SM, threads, records staged), ``-DSWEEP_...``
for kernel C in sweep.cu (tile, staged window, bin tables, hits kept),
``-DLISTS_...`` for the lists launch in uniq_layout.cu (rows sorted in
shared memory; a block past them takes the merge path). All are built
side by side (one nvcc each) into a temporary directory and run through
the port's own wrappers with the variant's library in place of the
shipped one: C on the sorted sphere table of the bed after three steps
and one refresh, the lists launch and B-ub on the SS table of a
DEMSolver after its first chunk (262,145 owners, shrunk). Each output is
held equal to the shipped build's (B-ub's to kernel B's), then CUDA events time 20 launches of each, two rounds
in turn, with kernel B on the same table beside B-ub.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# source -> (switch prefix, its C entries, {variant: switches})
VARIANTS = {
    "fused_force.cu": ("UB", ("dem_fused_hertz_ub",), {
        "as shipped": {},
        "2 CTAs/SM, 512 staged": {"CTAS_PER_SM": 2, "STAGE_B": 512},
    }),
    "sweep.cu": ("SWEEP", ("dem_sweep", "dem_sweep_tile"), {
        "as shipped": {},
        "bin tables of 256": {"BINS": 256},
        "bin tables of 1024": {"BINS": 1024},
        "no bin table": {"BINS": 0},
        "tile 128, window 1024, no bin table": {
            "TILE": 128, "WIN": 1024, "BINS": 0},
    }),
    "uniq_layout.cu": ("LISTS", ("dem_uniq_layout",), {
        "as shipped": {},
        "merge path (sort 128)": {"SORT": 128},
    }),
}


def start_build(_build, src, prefix, name, switches, workdir):
    so = os.path.join(workdir, src.split(".")[0] + "_" + "".join(
        c if c.isalnum() else "_" for c in name) + ".so")
    cmd = ([_build._nvcc()] + _build.ARCH_FLAGS + _build.NVCC_FLAGS
           + [f"-D{prefix}_{k}={v}" for k, v in switches.items()]
           + ["-Xptxas", "-v", "-shared", "-o", so, str(_build.CSRC / src)])
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def events_us(torch, fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clumps", type=int, default=262144)
    ap.add_argument("--k", type=int, default=25)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from dem_engine_tpu_torch import _build
    from dem_engine_tpu_torch.ops import binning, forces, sweep
    from dem_engine_tpu_torch.ops.fused_force import (hertz_rows_cuda,
                                                      hertz_rows_ub_cuda)
    from dem_engine_tpu_torch.solver import ss_search_inputs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    shipped = _build.lib()

    # kernel C's input: the bed's sorted sphere table
    eng, state, params = cs.kernel_bed(torch, args.clumps)
    q = ss_search_inputs(state, params.replace(max_drift=torch.tensor(
        25, dtype=torch.int32, device="cuda")), eng.cfg.voxel_size)
    S = state.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     S)
    cap_ss = eng.cfg.cap_ss
    del state
    # the lists launch's and B-ub's input: the API's table
    s = cs.api_table(args.clumps, args.k)
    su, n_u, ub = s.state.ss, s.state.owners.n, s.engine.cfg.uniq_cap
    krec = forces.pack_kinematics(s.state.owners, world_omg=True)
    h, vs, model = float(params.h), s.engine.cfg.voxel_size, \
        s.engine.cfg.force_model
    print(f"C: {S} spheres, {tab.n_rows} slots; lists and B-ub: rows "
          f"{su.cap} live {int(su.count)}, {n_u} owners, width {ub}")

    def sweep_call():
        return sweep.sweep_table_cuda(tab, S, q["family_mask"], q["nb_cd"],
                                      cap_ss)

    calls = {
        "fused_force.cu": lambda: hertz_rows_ub_cuda(su, krec, h, vs, model),
        "sweep.cu": sweep_call,
        "uniq_layout.cu": lambda: forces.uniq_layout_cuda(su, n_u, ub),
    }
    refs = {"fused_force.cu": hertz_rows_cuda(su, krec, h, vs, model),
            "sweep.cu": sweep_call(), "uniq_layout.cu": calls[
                "uniq_layout.cu"]()}

    class Lib:  # the shipped library with one source's entries a variant's
        def __init__(self, fns):
            self.fns = fns

        def __getattr__(self, name):
            return self.fns.get(name) or getattr(shipped, name)

    with tempfile.TemporaryDirectory() as workdir:
        builds = {(src, name): start_build(_build, src, prefix, name, sw,
                                           workdir)
                  for src, (prefix, _, vs_) in VARIANTS.items()
                  for name, sw in vs_.items()}
        libs = {}
        for (src, name), (so, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"{src} {name}: nvcc failed\n{log}")
            use = [ln.split("Used ")[1].strip() for ln in log.splitlines()
                   if "Used " in ln]
            so_lib = ctypes.CDLL(so)
            fns = {}
            for entry in VARIANTS[src][1]:
                fns[entry] = getattr(so_lib, entry)
                fns[entry].argtypes = _build.SIGNATURES[entry]
                fns[entry].restype = ctypes.c_int
            libs[src, name] = (Lib(fns), "; ".join(use))

        def run(src, name):
            lib = libs[src, name][0]
            _build.lib = lambda: lib
            try:
                return calls[src]()
            finally:
                _build.lib = lambda: shipped

        for src, name in libs:
            got = run(src, name)
            same = all(torch.equal(a, b) for a, b in zip(got, refs[src]))
            print(f"[variants] {src} {name}: equal to the shipped "
                  f"{'kernel B' if src == 'fused_force.cu' else 'build'}: "
                  f"{same} ({libs[src, name][1]})", flush=True)
        b_call = lambda: hertz_rows_cuda(su, krec, h, vs, model)  # noqa: E731
        for rnd in range(2):
            for src, name in libs:
                us = events_us(torch, lambda: run(src, name))
                print(f"[variants, round {rnd}] {src:15s} {name:36s} "
                      f"{us:7.1f} us", flush=True)
            print(f"[variants, round {rnd}] kernel B on the API's table "
                  f"{events_us(torch, b_call):7.1f} us", flush=True)


if __name__ == "__main__":
    main()
