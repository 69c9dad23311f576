"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 portbench/run.py --workload mono_1m.k20 --seed 7 --seconds 20 \
        --trace 0

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device
(and with --trace 1 the breakdown), and last the compared numbers with
their limits, which also end standard error. Exits nonzero without a
CUDA card, with fewer cards than the cell asks for, or when JAX or the
JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "dem_engine_tpu"}


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the boot clock (/proc/self/stat), or now
    where the kernel does not say."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return boot_clock()


def loaded_forbidden() -> set:
    return {m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton"),
                      ("CUDA_CACHE_PATH", "cuda")):
        os.environ[name] = str(CACHE / sub)
    # load from one process with few threads: the host's other cores are
    # shared, and the program's host side is one Python thread
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from portbench import harness

    bench = harness.load_bench(ROOT)
    chips = harness.resolve(bench, args.workload, ROOT)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import dem_engine_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[portbench] the program is not in this checkout: {e}",
              file=sys.stderr)
        return 4
    torch.cuda.set_device(0)
    result, extra = harness.run(bench, ROOT, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda:0",
                                t_start, boot_clock)
    bad = loaded_forbidden()
    if bad:
        print(f"[portbench] loaded in this process: {sorted(bad)}",
              file=sys.stderr)
        return 3
    print("[portbench] " + json.dumps(dict(
        detail=extra["detail"], setup_s=extra["setup_s"],
        frames=extra["window"]["frames"], wall_s=extra["window"]["wall_s"],
        frame_walls=extra["window"]["frame_walls"],
        profiled_frame_s=extra["profiled_frame_s"],
        clump_steps_per_s=extra["clump_steps_per_s"])), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
