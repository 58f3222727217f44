"""Read a cell's output check over many seeds in one process, for setting
its limits: the program as it runs, the program under the TF32 control,
or the program with a planted fault.

    python3 bench/tools/sweep.py --workload <cell> --seeds 11,12,13 \\
        --seconds 2 [--control tf32 | --fault half_batch] [--out FILE]

Each run is ``run.run_cell`` as the benchmark's command makes it, on the
card; one JSON line a run (seed, checks, correct, end-to-end metrics) is
printed and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run.run_cell(cell, seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), fault=args.fault,
                         control=args.control)
        line = {"workload": args.workload, "seed": seed,
                "control": args.control, "fault": args.fault,
                "correct": r["correct"], "checks": r["checks"],
                "metrics": r["metrics"], "attempted": r["attempted"],
                "wall_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
