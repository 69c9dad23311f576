"""Time variants of the port's segment-sum kernel A on one NVIDIA GPU.

    python3 -m dem_engine_tpu_torch.tools.segred_variants [--clumps 262144]

from the root of the repository (it takes its beds and timers from
chip_smoke.py). Each variant is csrc/segred.cu built with other values of
its build-time switches (``-DSEGRED_...``): another span per warp, no
block-level merge, no stop at the first dead group, scalar or no atomics,
a full or no scan. All are built side by side (one nvcc each) into a
temporary directory and launched back to back on the tables of the bed
after three steps and one refresh: the SS table's pair call, each of its
sides alone, and the SA table's pair call; CUDA events around 30
launches, two rounds in turn. Variants without atomics or scan give wrong
sums: they show what that part of the kernel costs, nothing else.

Then the host time of kernel D's wrapper and of its pieces, beside the
event medians of the wrapper and of chip_smoke.py's one ``index_add_``
call.
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

VARIANTS = {
    "as shipped": {},
    "no early stop": {"EARLY_STOP": 0},
    "span 128": {"GROUPS": 2},
    "span 512": {"GROUPS": 8},
    "span 1024": {"GROUPS": 16},
    "span 1024, 4 steps x 8": {"STEPS": 4, "GROUPS": 8},
    "4 warps a block": {"WARPS": 4},
    "no block merge": {"BLOCK_MERGE": 0},
    "scalar atomics": {"ATOMICS": 1},
    "no atomics": {"ATOMICS": 0},
    "no scan": {"SCAN_REACH": 0},
    "five rounds always": {"SCAN_REACH": 31},
}


def start_build(_build, name, switches, workdir):
    so = os.path.join(workdir, name.replace(" ", "_").replace(",", "")
                      + ".so")
    cmd = ([_build._nvcc()] + _build.ARCH_FLAGS + _build.NVCC_FLAGS
           + [f"-DSEGRED_{k}={v}" for k, v in switches.items()]
           + ["-Xptxas", "-v", "-shared", "-o", so,
              str(_build.CSRC / "segred.cu")])
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def events_us(torch, fn, reps=30):
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
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from dem_engine_tpu_torch import _build
    from dem_engine_tpu_torch.ops import segred

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    eng, state, params = cs.kernel_bed(torch, args.clumps)
    n, ss = state.owners.n, state.ss
    (t_ss, t_sa), sa, rec_bg = cs.segsum_inputs(eng, state, params)
    tabs = {"SS": t_ss, "SA": t_sa}
    out = torch.zeros((n, 6), device="cuda")
    stream = _build.stream_of(out)
    print(f"SS rows {ss.cap} live {int(ss.count)}, SA rows {sa.cap} live "
          f"{int(sa.count)}, owners {n}")

    def launch(lib, table, sides="ab"):
        ra, ia, rb, ib, pb = table
        a = ((ra.data_ptr(), ia.data_ptr(), None, ra.shape[0])
             if "a" in sides else (None, None, None, 0))
        b = ((rb.data_ptr(), ib.data_ptr(), pb.data_ptr(), rb.shape[0])
             if "b" in sides else (None, None, None, 0))
        _build.check(lib.dem_seg_sum_pair(*a, *b, n, out.data_ptr(), 0,
                                          stream), "dem_seg_sum_pair")

    with tempfile.TemporaryDirectory() as workdir:
        builds = {name: start_build(_build, name, switches, workdir)
                  for name, switches in VARIANTS.items()}
        libs = {}
        for name, (so, proc) in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{log}")
            regs = [ln.split("Used ")[1].split(",")[0]
                    for ln in log.splitlines() if "Used " in ln]
            lib = ctypes.CDLL(so)
            lib.dem_seg_sum_pair.argtypes = _build.SIGNATURES[
                "dem_seg_sum_pair"]
            lib.dem_seg_sum_pair.restype = ctypes.c_int
            libs[name] = (lib, regs[0] if regs else "?")

        def ss_sums(lib):
            out.zero_()
            launch(lib, tabs["SS"])
            return out.double()

        ref = ss_sums(libs["as shipped"][0])
        for name, (lib, _) in libs.items():
            err = float((ss_sums(lib) - ref).abs().max() / ref.abs().max())
            print(f"[variants] {name}: SS sums within {err:.1e} of the "
                  "shipped kernel's", flush=True)
        for rnd in range(2):
            for name, (lib, regs) in libs.items():
                t = [events_us(torch, lambda: launch(lib, tabs["SS"])),
                     events_us(torch, lambda: launch(lib, tabs["SS"], "a")),
                     events_us(torch, lambda: launch(lib, tabs["SS"], "b")),
                     events_us(torch, lambda: launch(lib, tabs["SA"]))]
                print(f"[variants, round {rnd}] {name:24s} {regs:14s} SS "
                      f"pair {t[0]:6.1f} us (A side {t[1]:5.1f}, B side "
                      f"{t[2]:5.1f}); SA pair {t[3]:5.1f} us", flush=True)

    # kernel D's wrapper on the SA table's floor side, piece by piece
    ids, dev, f32 = sa.own_b_sorted, rec_bg.device, torch.float32
    cap = rec_bg.shape[0]
    flag = torch.empty((), dtype=torch.bool, device=dev)
    lib = _build.lib()
    ptrs = (rec_bg.data_ptr(), ids.data_ptr(), out.data_ptr(),
            flag.data_ptr())
    index_add = cs.index_add_call(torch, rec_bg, ids, n)
    for label, fn in (
            ("D wrapper, whole", lambda: segred.seg_sum_sorted_v1(
                rec_bg, ids, n)),
            ("  torch.empty of the sums", lambda: torch.empty(
                (n, 6), dtype=f32, device=dev)),
            ("  torch.empty of the flag", lambda: torch.empty(
                (), dtype=torch.bool, device=dev)),
            ("  the two argument checks", lambda: (
                _build.require(rec_bg, f32, (cap, 6)),
                _build.require(ids, torch.int32, (cap,)))),
            ("  current stream handle", lambda: _build.stream_of(rec_bg)),
            ("  ctypes call and cooperative launch",
             lambda: lib.dem_seg_sum_v1(ptrs[0], ptrs[1], cap, n, 512, 256,
                                        ptrs[2], ptrs[3], stream)),
            ("  torch.zeros of its sums", lambda: torch.zeros(
                (n + 1, 6), dtype=f32, device=dev))):
        print(f"[host] {label}: {cs.host_us(torch, fn):.1f} us", flush=True)
    ev_d = cs.cuda_ms(torch, lambda: segred.seg_sum_sorted_v1(rec_bg, ids, n),
                      reps=50)
    ev_lib = cs.cuda_ms(torch, index_add, reps=50)
    print(f"[events] D {ev_d * 1e3:.1f} us, index_add_ {ev_lib * 1e3:.1f} us "
          "(medians of 50)")


if __name__ == "__main__":
    main()
