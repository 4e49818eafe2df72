#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, the
numbers compared for the program and, with ``--control 1``, for the control
(the reference computed in float8 in the program's place), in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 1] [--seconds 2]

One JSON line a seed. Train cells read their captured steps (no window);
the others a window of ``--seconds`` at the cell's load.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("refused: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed,
                                      seconds=args.seconds, trace=0)
        ctx = harness.RunContext(run_args, time.perf_counter())
        found = harness.mix_module(ctx.traffic["kind"]).calibration(
            ctx, bool(args.control))
        print(json.dumps({"seed": seed, **found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
