"""Readings that set the limits of ``correct``: the program's numbers on
many seeds and, from the same captured inputs, those of the reference
put in the program's place as the control (computed in bfloat16) and
with each of the configuration's small terms left out (the cohesion, the
rolling resistance: float64, the term's value 0).

    python3 portbench/control.py --workload mono_1m.k20 --seeds 1,2,3 \
        --seconds 2

One process; one JSON line per seed. The benchmark's own runs do not run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def controls(cfg: dict) -> list:
    """(label, dtype, material, search) of each reference put in the
    program's place: the control (whose bfloat16 search finds hardly a
    pair, nor any floor row), the control's step alone on the program's
    pairs (so that every row's number has a reading), and a fault for
    each small term the configuration has."""
    import torch

    out = [("bfloat16", torch.bfloat16, None, True),
           ("bfloat16_step", torch.bfloat16, None, False)]
    coh = cfg["force_model"].get("cohesion")
    if coh:
        out.append(("no_cohesion", torch.float64, {coh["pair_prop"]: 0.0},
                    True))
    if float(cfg["material"].get("Crr", 0.0)) > 0:
        out.append(("no_rolling", torch.float64, {"Crr": 0.0}, True))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    also = controls(harness.resolve(bench, args.workload, ROOT)["config"])
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, extra = harness.run(bench, ROOT, args.workload, seed,
                                    args.seconds, False, "cuda:0", t0,
                                    time.perf_counter,
                                    also=also)
        d = extra["detail"]
        print(json.dumps(dict(
            seed=seed, correct=result["correct"],
            program={k: c["value"] for k, c in result["checks"].items()},
            controls=d.pop("controls"), detail=d,
            metrics={k: m["value"] for k, m in result["metrics"].items()},
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
